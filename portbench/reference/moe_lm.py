"""The decoder-only MoE language model (qwen2-moe as the configuration
states it), plain.

Layer: RMSNorm, causal self-attention with RoPE (q, k, v biases), RMSNorm,
then the MoE: an f32 router, softmax over the routed experts, the top-k
weights renormalised to sum to 1, each routed expert a SwiGLU, plus the
shared experts' SwiGLU.  In a prefill over T tokens an expert takes at
most ``min(ceil(T k / E * capacity_factor), T)`` of its (token, expert)
pairs, the earliest in token order (then in rank order within a token);
the rest are dropped.  A decode step drops nothing.
"""
from __future__ import annotations

import math

import torch

from portbench.reference.common import Precision, attend_rows, attention, layer, rmsnorm, rope, swiglu


def _heads(x, c):
    return x.reshape(*x.shape[:-1], -1, c["d_head"])


def _qkv(a, h, c, pr):
    return (_heads(pr.mm(h, a["wq"]) + a["bq"].float(), c),
            _heads(pr.mm(h, a["wk"]) + a["bk"].float(), c),
            _heads(pr.mm(h, a["wv"]) + a["bv"].float(), c))


def route(h: torch.Tensor, router: torch.Tensor, k: int, pr: Precision):
    """h (T, M) -> combine weights (T, k) and expert ids (T, k)."""
    probs = torch.softmax(pr.mm(h, router), dim=-1)
    wts, ids = torch.topk(probs, k, dim=-1)
    return wts / wts.sum(-1, keepdim=True).clamp_min(1e-9), ids


def kept(ids: torch.Tensor, n_experts: int, cap: int) -> torch.Tensor:
    """(T, k) bool: whether each pair is among the first ``cap`` of its
    expert, in the flat (token, rank) order."""
    flat = ids.reshape(-1)
    onehot = torch.nn.functional.one_hot(flat, n_experts).to(torch.int32)
    rank = onehot.cumsum(0).gather(1, flat[:, None])[:, 0] - 1
    return (rank < cap).reshape(ids.shape)


def moe(p: dict, h: torch.Tensor, c: dict, pr: Precision, cap: int | None) -> torch.Tensor:
    """h (T, M) f32 -> (T, M); ``cap`` None: nothing dropped."""
    m = c["moe"]
    wts, ids = route(h, p["router"], m["top_k"], pr)
    if cap is not None:
        wts = wts * kept(ids, m["n_routed"], cap)
    out = torch.zeros_like(h)
    for e in ids.unique().tolist():
        tok, slot = (ids == e).nonzero(as_tuple=True)
        y = swiglu(h[tok], p["experts_wg"][e], p["experts_wu"][e], p["experts_wd"][e], pr)
        out.index_add_(0, tok, y * wts[tok, slot][:, None])
    s = p["shared"]
    return out + swiglu(h, s["wg"], s["wu"], s["wd"], pr)


def capacity(c: dict, tokens: int) -> int:
    m = c["moe"]
    return min(int(math.ceil(tokens * m["top_k"] / m["n_routed"] * m["capacity_factor"])), tokens)


def prefill(w: dict, tokens: torch.Tensor, c: dict, pr: Precision):
    """tokens (B, S): yields ``(layer, k, v)`` of each layer's cache (roped
    keys, values; (B, S, Hkv, D) f32), then ``("logits", last, None)``:
    the last position's logits (B, V)."""
    B, S = tokens.shape
    eps, theta = c["norm_eps"], c["rope_theta"]
    pos = torch.arange(S, device=tokens.device)[None, :]
    cap = capacity(c, B * S)
    x = w["emb"][tokens.long()].float()
    for i in range(c["n_layers"]):
        p = layer(w["layers"], i)
        h = rmsnorm(x, p["ln1"], eps)
        q, k, v = _qkv(p["attn"], h, c, pr)
        q, k = rope(q, pos, theta), rope(k, pos, theta)
        yield i, k, v
        o = attention(q, k, v, pr, causal=True, q_block=512)
        x = x + pr.mm(o.flatten(-2), p["attn"]["wo"])
        h = rmsnorm(x, p["ln2"], eps)
        x = x + moe(p["moe"], h.reshape(B * S, -1), c, pr, cap).reshape(x.shape)
    yield "logits", pr.mm(rmsnorm(x[:, -1], w["final_norm"], eps), w["lm_head"]), None


class Decoder:
    """Decode steps against a cache whose slots below each row's start
    hold ``first`` and whose later slots the steps write."""

    def __init__(self, w: dict, c: dict, pr: Precision, first_kv, slots: int):
        self.w, self.c, self.pr = w, c, pr
        self.k, self.v = [], []
        for _, k, v in first_kv:
            self.k.append(k.float())
            self.v.append(v.float())
        assert len(self.k) == c["n_layers"] and self.k[0].shape[1] == slots

    def step(self, tok: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        w, c, pr = self.w, self.c, self.pr
        eps, theta = c["norm_eps"], c["rope_theta"]
        rows = torch.arange(tok.shape[0], device=tok.device)
        x = w["emb"][tok.long()].float()
        for i in range(c["n_layers"]):
            p = layer(w["layers"], i)
            h = rmsnorm(x, p["ln1"], eps)
            q, k, v = _qkv(p["attn"], h, c, pr)
            q = rope(q[:, None], pos[:, None], theta)[:, 0]
            k = rope(k[:, None], pos[:, None], theta)[:, 0]
            self.k[i][rows, pos.long()] = k
            self.v[i][rows, pos.long()] = v
            o = attend_rows(q, self.k[i], self.v[i], pos + 1, pr)
            x = x + pr.mm(o.flatten(-2), p["attn"]["wo"])
            h = rmsnorm(x, p["ln2"], eps)
            x = x + moe(p["moe"], h, c, pr, None)
        return pr.mm(rmsnorm(x, w["final_norm"], eps), w["lm_head"])
