"""GQA attention: prefill (flash kernel) and decode (KV-cache kernel) paths.

Port of ``repro/models/attention.py``: self-attention with the vlm
family's QK-norm after RoPE, and the encoder-decoder's cross-attention
(K/V projected from the encoder stream, no RoPE, no biases).

Under an active mesh (``repro_torch.sharding.use_mesh_rules``) the
activations are DTensors, and the kernels never see one: the attention
core and the decode step's cache write and attention run inside
``local_map``, so each kernel wrapper gets one rank's local tensors (on the
card it launches its CUDA kernel).  A rank's q heads follow ``act_heads``
and every query sees the whole sequence.  With GQA the K/V heads stay
replicated on the mesh (the reference's ``replicate_kv``), and each rank
cuts out the kv heads its q heads read; their gradients are ``Partial``
sums over the head-sharding mesh dims, reduced where the replicated
projection's gradient needs them, as GSPMD reduces them.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.distributed.tensor import zeros as dtensor_zeros
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import apply_rope, dense_init, pdtype, qk_norm
from repro_torch.sharding import active_mesh, constrain, logical_spec
from repro_torch.sharding.specs import placements_for, shard_offset


def init_attn(generator, cfg, layers: int | None = None, device="cuda",
              cross: bool = False) -> dict:
    """``cross=True``: the K/V projections read the encoder stream, and
    there are no biases even where ``cfg.qkv_bias`` is set."""
    dt = pdtype(cfg)
    M, Q, KV = cfg.d_model, cfg.q_dim, cfg.kv_dim
    lead = () if layers is None else (layers,)
    p = {
        "wq": dense_init(generator, (M, Q), dt, layers=layers, device=device),
        "wk": dense_init(generator, (M, KV), dt, layers=layers, device=device),
        "wv": dense_init(generator, (M, KV), dt, layers=layers, device=device),
        "wo": dense_init(generator, (Q, M), dt, layers=layers, device=device),
    }
    if cfg.qkv_bias and not cross:
        p["bq"] = torch.zeros((*lead, Q), dtype=dt, device=device)
        p["bk"] = torch.zeros((*lead, KV), dtype=dt, device=device)
        p["bv"] = torch.zeros((*lead, KV), dtype=dt, device=device)
    return p


def _project_q(p, x, cfg):
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    if not _heads_divide(cfg.n_heads):
        # the q heads stay whole on each rank (qwen2.5-14b's 40 on a model
        # axis of 16): DTensor cannot cut heads out of a feature shard
        q = constrain(q, ("act_batch", "act_seq", None))
    return q.reshape(*x.shape[:-1], cfg.n_heads, cfg.d_head)


def _heads_divide(n_heads: int) -> bool:
    """Whether the mesh axes of ``act_heads`` divide ``n_heads`` (true
    without an active mesh)."""
    mesh = active_mesh()
    if mesh is None:
        return True
    (entry,) = logical_spec(("act_heads",), mesh)
    names = () if entry is None else (entry,) if isinstance(entry, str) else entry
    size = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return n_heads % math.prod(size[a] for a in names) == 0


def _project_kv(p, x, cfg):
    if active_mesh() is not None and cfg.n_kv_heads < cfg.n_heads:
        k, v = _replicated_kv(x, p["wk"], p["wv"])
    else:
        k = x @ p["wk"]
        v = x @ p["wv"]
    if "bk" in p:
        k = k + p["bk"]
        v = v + p["bv"]
    shape = (*x.shape[:-1], cfg.n_kv_heads, cfg.d_head)
    return k.reshape(shape), v.reshape(shape)


def _replicated_kv(x, wk, wv):
    """``x @ wk, x @ wv`` with the products replicated on every mesh dim
    that does not shard the batch (the reference's GQA strategy: tiny
    redundant kv projections, heads never split).  Left to itself, DTensor
    may shard the product's columns on "model", which then cannot be cut
    into fewer kv heads than the axis has ranks."""
    mesh = active_mesh()
    x_pl = placements_for(("act_batch", None, None), x.shape, mesh)
    w_pl = [Replicate()] * mesh.ndim
    w_grad = [Partial() if isinstance(a, Shard) else Replicate() for a in x_pl]
    return local_map(lambda x, wk, wv: (x @ wk, x @ wv), out_placements=(x_pl, x_pl),
                     in_placements=(x_pl, w_pl, w_pl), in_grad_placements=(x_pl, w_grad, w_grad),
                     device_mesh=mesh, redistribute_inputs=True)(x, wk, wv)


def attn_apply(p: dict, x: torch.Tensor, cfg, positions: torch.Tensor, *, causal: bool = True,
               kv_src: torch.Tensor | None = None):
    """Full-sequence attention (prefill).  x: (B, S, M); ``kv_src``
    (B, Skv, M) is the cross-attention's source, whose K/V take no RoPE.

    Returns ``(out, k, v)``: the keys attention used (roped, and for the
    vlm family QK-normed) and the values are what a prefill stores in its
    cache, so the cache needs no second projection.  The reference's
    prefill rebuilds its cache keys without the QK-norm, so its vlm cache
    holds raw keys from a prefill and normed keys from decode steps; here
    both are normed (pinned by ``tests/test_torch_vlm.py``)."""
    B, S, _ = x.shape
    q = _project_q(p, x, cfg)
    k, v = _project_kv(p, x if kv_src is None else kv_src, cfg)
    if kv_src is None and cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if cfg.family == "vlm":
        q, k = qk_norm(q), qk_norm(k)
    # GQA with TP > n_kv_heads: kv stays head-replicated (projections are
    # replicated too)
    kv_axis = None if cfg.n_kv_heads < cfg.n_heads else "act_kv_heads"
    q = constrain(q, ("act_batch", "act_seq", "act_heads", None))
    k = constrain(k, ("act_batch", "act_seq", kv_axis, None))
    v = constrain(v, ("act_batch", "act_seq", kv_axis, None))
    out = _attention(q, k, v, causal)
    out = constrain(out.reshape(B, S, cfg.q_dim), ("act_batch", "act_seq", "act_heads"))
    return out @ p["wo"], k, v


def _kv_heads(mesh, q_pl, hq: int, hkv: int, head_dim: int) -> tuple[int, int]:
    """``[lo, hi)``: the kv heads this rank's q heads read (q's heads at
    tensor dim ``head_dim`` sharded by ``q_pl``, kv heads replicated)."""
    idx, n = shard_offset(mesh, q_pl, head_dim)
    hl, g = hq // n, hq // hkv
    lo, hi = idx * hl // g, ((idx + 1) * hl - 1) // g + 1
    assert hl % (hi - lo) == 0, (hq, hkv, n)
    return lo, hi


def _attention(q, k, v, causal: bool):
    """The flash kernel over (B, S, H, D) q, k, v; inside ``local_map``
    under an active mesh (the sequence gathered, heads as ``act_heads``)."""
    mesh = active_mesh()
    if mesh is None:
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal)
    hq, hkv = q.shape[2], k.shape[2]
    q_pl = placements_for(("act_batch", None, "act_heads", None), q.shape, mesh)
    if hkv == hq:
        kv_pl = kv_grad = q_pl
        lo, hi = 0, hkv
    else:
        kv_pl = placements_for(("act_batch", None, None, None), k.shape, mesh)
        lo, hi = _kv_heads(mesh, q_pl, hq, hkv, 2)
        kv_grad = [Partial() if isinstance(a, Shard) and a.dim == 2 else b
                   for a, b in zip(q_pl, kv_pl)]

    def local(q, k, v):
        if hi - lo < k.shape[2]:
            k, v = k[:, :, lo:hi], v[:, :, lo:hi]
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal)

    return local_map(local, out_placements=q_pl, in_placements=(q_pl, kv_pl, kv_pl),
                     in_grad_placements=(q_pl, kv_grad, kv_grad), device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v)


def _decode_attention(q, k_cache, v_cache, lengths):
    """The decode kernel over q (B, Hq, D) and (B, Smax, Hkv, D) caches;
    inside ``local_map`` under an active mesh: batch as ``act_batch``, q
    heads as ``act_heads``, a sequence-sharded cache gathered."""
    mesh = active_mesh()
    if mesh is None:
        return decode_attention(q.contiguous(), k_cache, v_cache, lengths)
    hq, hkv = q.shape[1], k_cache.shape[2]
    q_pl = placements_for(("act_batch", "act_heads", None), q.shape, mesh)
    len_pl = [a if isinstance(a, Shard) and a.dim == 0 else Replicate() for a in q_pl]
    c_pl = [a if isinstance(a, Shard) and a.dim != 1 else Replicate() for a in k_cache.placements]
    lo, hi = 0, hkv
    if not any(isinstance(a, Shard) and a.dim == 2 for a in c_pl):
        lo, hi = _kv_heads(mesh, q_pl, hq, hkv, 1)

    def local(q, kc, vc, n):
        if hi - lo < kc.shape[2]:
            kc, vc = kc[:, :, lo:hi].contiguous(), vc[:, :, lo:hi].contiguous()
        return decode_attention(q.contiguous(), kc, vc, n)

    return local_map(local, out_placements=q_pl, in_placements=(q_pl, c_pl, c_pl, len_pl),
                     device_mesh=mesh, redistribute_inputs=True)(q, k_cache, v_cache, lengths)


def _write_row(cache: dict, k_t, v_t, pos) -> None:
    """``cache[b, pos[b]] = k_t[b], v_t[b]`` in place; under an active mesh
    on each rank's own shard of the cache (a sequence-sharded shard takes
    the rows whose position falls in it)."""
    mesh = active_mesh()
    if mesh is None:
        b_idx = torch.arange(pos.shape[0], device=pos.device)
        idx = pos.long()
        cache["k"][b_idx, idx] = k_t.to(cache["k"].dtype)
        cache["v"][b_idx, idx] = v_t.to(cache["v"].dtype)
        return
    c_pl = list(cache["k"].placements)
    t_pl = [Shard(a.dim - 1 if a.dim > 1 else 0) if isinstance(a, Shard) and a.dim != 1
            else Replicate() for a in c_pl]
    pos_pl = [a if isinstance(a, Shard) and a.dim == 0 else Replicate() for a in c_pl]
    seq_idx, seq_n = shard_offset(mesh, c_pl, 1)

    def local(kc, vc, kt, vt, p):
        n = kc.shape[1]
        p = p.long() - seq_idx * n
        b_idx = torch.arange(p.shape[0], device=p.device)
        if seq_n > 1:
            mine = (p >= 0) & (p < n)
            b_idx, p, kt, vt = b_idx[mine], p[mine], kt[mine], vt[mine]
        kc[b_idx, p] = kt.to(kc.dtype)
        vc[b_idx, p] = vt.to(vc.dtype)
        return kc, vc

    local_map(local, out_placements=(c_pl, c_pl), in_placements=(c_pl, c_pl, t_pl, t_pl, pos_pl),
              device_mesh=mesh, redistribute_inputs=True)(
        cache["k"], cache["v"], k_t, v_t, pos)


def init_kv_cache(cfg, batch: int, max_len: int, layers: int | None = None,
                  device="cuda") -> dict:
    """Zero K/V cache (B, Smax, Hkv, D), or (L, B, Smax, Hkv, D) with ``layers``;
    a profiler range ``kv_cache.init``."""
    lead = () if layers is None else (layers,)
    shape = (*lead, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    dt = pdtype(cfg)
    mesh = active_mesh()
    with torch.profiler.record_function("kv_cache.init"):
        if mesh is not None:   # a DTensor laid out as the cache spec tree says
            kv_axis = None if cfg.n_kv_heads < cfg.n_heads else "act_kv_heads"
            pl = placements_for((*(None,) * len(lead), "act_batch", "act_seq_cache", kv_axis,
                                 None), shape, mesh)
            return {n: dtensor_zeros(shape, dtype=dt, device_mesh=mesh, placements=pl)
                    for n in ("k", "v")}
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}


def attn_decode(p: dict, x_t: torch.Tensor, cache: dict, pos: torch.Tensor, cfg, *,
                cross_kv: dict | None = None):
    """One decode step.  x_t: (B, M); cache {"k","v"}: (B, Smax, Hkv, D);
    pos: (B,) int32 write positions (= lengths so far).  With ``cross_kv``
    (:func:`precompute_cross_kv`'s ``{"k", "v", "len"}``) the step attends
    to the encoder's K/V over ``len`` frames instead, applies no RoPE and
    writes nothing to ``cache``.

    The new K/V row is written into ``cache`` in place: the reference
    returns a fresh cache (``.at[].set``), which at the llama3-8b decode
    shape would copy a 17 GB cache every step.  The reference also drops a
    write at ``pos >= Smax`` silently; here that index faults, so callers
    size ``Smax`` to the last position they decode."""
    B, _ = x_t.shape
    q = _project_q(p, x_t[:, None, :], cfg)[:, 0]           # (B, Hq, D)
    if cross_kv is not None:
        if cfg.family == "vlm":   # the reference's branch; no registry config reaches it
            q = qk_norm(q)
        out = _decode_attention(q, cross_kv["k"], cross_kv["v"], cross_kv["len"])
        return out.reshape(B, cfg.q_dim) @ p["wo"], cache
    k_t, v_t = _project_kv(p, x_t[:, None, :], cfg)
    k_t, v_t = k_t[:, 0], v_t[:, 0]                         # (B, Hkv, D)
    if cfg.rope_theta > 0:
        q = apply_rope(q[:, None], pos[:, None], cfg.rope_theta)[:, 0]
        k_t = apply_rope(k_t[:, None], pos[:, None], cfg.rope_theta)[:, 0]
    if cfg.family == "vlm":
        q, k_t = qk_norm(q), qk_norm(k_t)
    _write_row(cache, k_t, v_t, pos)
    out = _decode_attention(q, cache["k"], cache["v"], (pos + 1).to(torch.int32))
    out = constrain(out, ("act_batch", "act_heads", None))
    return out.reshape(B, cfg.q_dim) @ p["wo"], cache


def precompute_cross_kv(p: dict, enc_out: torch.Tensor, enc_lens: torch.Tensor, cfg) -> dict:
    """Encoder-side K/V of cross-attention, computed once a session:
    ``{"k", "v"}`` (B, Se, Hkv, D) and ``"len"`` (B,) int32."""
    k, v = _project_kv(p, enc_out, cfg)
    return {"k": k, "v": v, "len": enc_lens}
