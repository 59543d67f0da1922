"""GQA attention: prefill (flash kernel) and decode (KV-cache kernel) paths.

Port of the self-attention parts of ``repro/models/attention.py``, with
the vlm family's QK-norm after RoPE.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import apply_rope, dense_init, pdtype, qk_norm


def init_attn(generator, cfg, layers: int | None = None, device="cuda") -> dict:
    dt = pdtype(cfg)
    M, Q, KV = cfg.d_model, cfg.q_dim, cfg.kv_dim
    lead = () if layers is None else (layers,)
    p = {
        "wq": dense_init(generator, (M, Q), dt, layers=layers, device=device),
        "wk": dense_init(generator, (M, KV), dt, layers=layers, device=device),
        "wv": dense_init(generator, (M, KV), dt, layers=layers, device=device),
        "wo": dense_init(generator, (Q, M), dt, layers=layers, device=device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((*lead, Q), dtype=dt, device=device)
        p["bk"] = torch.zeros((*lead, KV), dtype=dt, device=device)
        p["bv"] = torch.zeros((*lead, KV), dtype=dt, device=device)
    return p


def _project_q(p, x, cfg):
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    return q.reshape(*x.shape[:-1], cfg.n_heads, cfg.d_head)


def _project_kv(p, x, cfg):
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bk" in p:
        k = k + p["bk"]
        v = v + p["bv"]
    shape = (*x.shape[:-1], cfg.n_kv_heads, cfg.d_head)
    return k.reshape(shape), v.reshape(shape)


def attn_apply(p: dict, x: torch.Tensor, cfg, positions: torch.Tensor, *, causal: bool = True):
    """Full-sequence attention (prefill).  x: (B, S, M).

    Returns ``(out, k, v)``: the keys attention used (roped, and for the
    vlm family QK-normed) and the values are what a prefill stores in its
    cache, so the cache needs no second projection.  The reference's
    prefill rebuilds its cache keys without the QK-norm, so its vlm cache
    holds raw keys from a prefill and normed keys from decode steps; here
    both are normed (pinned by ``tests/test_torch_vlm.py``)."""
    B, S, _ = x.shape
    q = _project_q(p, x, cfg)
    k, v = _project_kv(p, x, cfg)
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if cfg.family == "vlm":
        q, k = qk_norm(q), qk_norm(k)
    out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal)
    return out.reshape(B, S, cfg.q_dim) @ p["wo"], k, v


def init_kv_cache(cfg, batch: int, max_len: int, layers: int | None = None,
                  device="cuda") -> dict:
    """Zero K/V cache (B, Smax, Hkv, D), or (L, B, Smax, Hkv, D) with ``layers``."""
    lead = () if layers is None else (layers,)
    shape = (*lead, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    dt = pdtype(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def attn_decode(p: dict, x_t: torch.Tensor, cache: dict, pos: torch.Tensor, cfg):
    """One decode step.  x_t: (B, M); cache {"k","v"}: (B, Smax, Hkv, D);
    pos: (B,) int32 write positions (= lengths so far).

    The new K/V row is written into ``cache`` in place: the reference
    returns a fresh cache (``.at[].set``), which at the llama3-8b decode
    shape would copy a 17 GB cache every step.  The reference also drops a
    write at ``pos >= Smax`` silently; here that index faults, so callers
    size ``Smax`` to the last position they decode."""
    B, _ = x_t.shape
    q = _project_q(p, x_t[:, None, :], cfg)[:, 0]           # (B, Hq, D)
    k_t, v_t = _project_kv(p, x_t[:, None, :], cfg)
    k_t, v_t = k_t[:, 0], v_t[:, 0]                         # (B, Hkv, D)
    if cfg.rope_theta > 0:
        q = apply_rope(q[:, None], pos[:, None], cfg.rope_theta)[:, 0]
        k_t = apply_rope(k_t[:, None], pos[:, None], cfg.rope_theta)[:, 0]
    if cfg.family == "vlm":
        q, k_t = qk_norm(q), qk_norm(k_t)
    b_idx = torch.arange(B, device=x_t.device)
    idx = pos.long()
    cache["k"][b_idx, idx] = k_t.to(cache["k"].dtype)
    cache["v"][b_idx, idx] = v_t.to(cache["v"].dtype)
    out = decode_attention(q.contiguous(), cache["k"], cache["v"], (pos + 1).to(torch.int32))
    return out.reshape(B, cfg.q_dim) @ p["wo"], cache
