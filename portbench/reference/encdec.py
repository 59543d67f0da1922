"""The encoder-decoder (seamless-m4t as the configuration states it), plain.

Encoder: pre-norm layers of non-causal self-attention with RoPE at the
frame positions (q, k, v biases) and a tanh-GELU MLP, over every frame,
then the final encoder norm.  Decoder layer: causal self-attention with
RoPE, cross-attention to the encoder's output (no RoPE, no biases; a row
reads its first ``enc_lens`` frames in decode), GELU MLP; RMSNorm before
each; logits through an untied head.
"""
from __future__ import annotations

import torch

from portbench.reference.common import (
    Precision, attend_rows, attention, gelu_tanh, layer, rmsnorm, rope,
)


def _heads(x, c):
    return x.reshape(*x.shape[:-1], -1, c["d_head"])


def encoder(w: dict, frames: torch.Tensor, c: dict, pr: Precision) -> torch.Tensor:
    """frames (B, Se, M) -> the normed encoder output (B, Se, M) f32."""
    x = frames.float()
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    eps, theta = c["norm_eps"], c["rope_theta"]
    for i in range(c["n_enc_layers"]):
        p = layer(w["enc_layers"], i)
        a = p["attn"]
        h = rmsnorm(x, p["ln1"], eps)
        q = _heads(pr.mm(h, a["wq"]) + a["bq"].float(), c)
        k = _heads(pr.mm(h, a["wk"]) + a["bk"].float(), c)
        v = _heads(pr.mm(h, a["wv"]) + a["bv"].float(), c)
        o = attention(rope(q, pos, theta), rope(k, pos, theta), v, pr, causal=False, q_block=512)
        x = x + pr.mm(o.flatten(-2), a["wo"])
        h = rmsnorm(x, p["ln2"], eps)
        x = x + pr.mm(gelu_tanh(pr.mm(h, p["mlp"]["wu"])), p["mlp"]["wd"])
    return rmsnorm(x, w["enc_norm"], eps)


def cross_kv(w: dict, enc_out: torch.Tensor, c: dict, pr: Precision):
    """``(layer, k, v)`` of each decoder layer's cross-attention over the
    encoder's output, (B, Se, Hkv, D) f32."""
    for i in range(c["n_layers"]):
        x = layer(w["dec_layers"], i)["xattn"]
        yield i, _heads(pr.mm(enc_out, x["wk"]), c), _heads(pr.mm(enc_out, x["wv"]), c)


class Decoder:
    """Decode steps of ``rows`` sequences against a self cache whose slots
    below each row's start hold ``first`` (the cache's first contents) and
    whose later slots the steps write, and the cross K/V of the encoder's
    output at ``enc_lens`` valid frames."""

    def __init__(self, w: dict, c: dict, pr: Precision, first_kv, cross, enc_lens, slots: int):
        self.w, self.c, self.pr = w, c, pr
        self.k, self.v = [], []
        for _, k, v in first_kv:                  # (B, Smax, Hkv, D) each
            self.k.append(k.float())
            self.v.append(v.float())
        assert len(self.k) == c["n_layers"] and self.k[0].shape[1] == slots
        self.cross = [(k, v) for _, k, v in cross]
        self.enc_lens = enc_lens

    def step(self, tok: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """tok, pos (B,) -> logits (B, V) f32; writes slot ``pos``."""
        w, c, pr = self.w, self.c, self.pr
        eps, theta = c["norm_eps"], c["rope_theta"]
        rows = torch.arange(tok.shape[0], device=tok.device)
        x = w["emb"][tok.long()].float()
        for i in range(c["n_layers"]):
            p = layer(w["dec_layers"], i)
            a = p["attn"]
            h = rmsnorm(x, p["ln1"], eps)
            q = _heads(pr.mm(h, a["wq"]) + a["bq"].float(), c)
            k = _heads(pr.mm(h, a["wk"]) + a["bk"].float(), c)
            v = _heads(pr.mm(h, a["wv"]) + a["bv"].float(), c)
            q = rope(q[:, None], pos[:, None], theta)[:, 0]
            k = rope(k[:, None], pos[:, None], theta)[:, 0]
            self.k[i][rows, pos.long()] = k
            self.v[i][rows, pos.long()] = v
            o = attend_rows(q, self.k[i], self.v[i], pos + 1, pr)
            x = x + pr.mm(o.flatten(-2), a["wo"])
            xa = p["xattn"]
            h = rmsnorm(x, p["ln_x"], eps)
            q = _heads(pr.mm(h, xa["wq"]), c)
            ck, cv = self.cross[i]
            o = attend_rows(q, ck, cv, self.enc_lens, pr)
            x = x + pr.mm(o.flatten(-2), xa["wo"])
            h = rmsnorm(x, p["ln2"], eps)
            x = x + pr.mm(gelu_tanh(pr.mm(h, p["mlp"]["wu"])), p["mlp"]["wd"])
        return pr.mm(rmsnorm(x, w["final_norm"], eps), w["lm_head"])
