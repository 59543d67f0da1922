"""Mamba-1 selective SSM block (Jamba's sequence mixer).

Port of ``repro/models/mamba.py``.  The reference scans a sequence in
chunks of ``MambaCfg.chunk`` steps: a ``lax.scan`` over the chunks carries
the (B, d_inner, N) state, and an ``associative_scan`` inside each chunk
runs the recurrence ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t`` in
parallel.  PyTorch has no associative scan, and a loop over tokens would
be some 30 launches a token and layer (host-bound, as the sLSTM loop is).
Here each chunk is scanned in log2(chunk) rounds of shifted products
(Hillis–Steele) with the reference's ``combine``, and the chunks are a
host loop (marked ``mamba_scan`` for the profiler).  The f32 islands are
the reference's: the ``x1 @ w_x`` product
in the model dtype then f32, the softplus and the scan in f32, the D skip
in f32.  Decode is the O(1) recurrent step.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.launch import roofline
from repro_torch.models.layers import causal_conv1d, conv1d_step, dense_init, halves, pdtype
from repro_torch.sharding import active_mesh, constrain
from repro_torch.sharding.specs import placements_for


def _dt_rank(cfg) -> int:
    return cfg.mamba.dt_rank or math.ceil(cfg.d_model / 16)


def d_inner(cfg) -> int:
    return cfg.mamba.expand * cfg.d_model


def init_mamba(generator, cfg, layers: int | None = None, device="cuda") -> dict:
    mc = cfg.mamba
    dt = pdtype(cfg)
    M, D, N, R = cfg.d_model, d_inner(cfg), mc.d_state, _dt_rank(cfg)
    lead = () if layers is None else (layers,)
    f32 = torch.float32
    # dt bias: softplus(b_dt) ~ Uniform[1e-3, 0.1] (mamba init)
    u = torch.empty((*lead, D), dtype=f32, device=device).uniform_(1e-3, 0.1, generator=generator)
    a_log = torch.log(torch.arange(1, N + 1, dtype=f32, device=device))
    return {
        "w_in": dense_init(generator, (M, 2 * D), dt, layers=layers, device=device),
        "conv_w": dense_init(generator, (mc.d_conv, D), dt, layers=layers, device=device),
        "conv_b": torch.zeros((*lead, D), dtype=dt, device=device),
        "w_x": dense_init(generator, (D, R + 2 * N), dt, layers=layers, device=device),
        "w_dt": dense_init(generator, (R, D), f32, layers=layers, device=device).mul_(R ** -0.5),
        "b_dt": u + torch.log(-torch.expm1(-u)),                  # inverse softplus
        "A_log": a_log.expand(*lead, D, N).contiguous(),
        "D": torch.ones((*lead, D), dtype=f32, device=device),
        "w_out": dense_init(generator, (D, M), dt, layers=layers, device=device),
    }


def _ssm_inputs(p: dict, x1: torch.Tensor, cfg):
    """x1: (..., D) post-conv activations -> f32 (dt, Bs, Cs)."""
    N, R = cfg.mamba.d_state, _dt_rank(cfg)
    # a contraction over the d_inner that "model" shards: its Partial sum
    # reduced here, once, and not carried on into the dt product
    xdbc = constrain(x1 @ p["w_x"], ("act_batch", "act_seq", None) if x1.ndim == 3
                     else ("act_batch", None))
    dt_r, Bs, Cs = xdbc.float().split([R, N, N], dim=-1)
    dt = F.softplus(dt_r @ p["w_dt"] + p["b_dt"])                 # (..., D)
    return dt, Bs, Cs


def _scan_chunk(da: torch.Tensor, inp: torch.Tensor, h: torch.Tensor):
    """The recurrence over one chunk from state ``h`` (B, D, N): ``da``
    and ``inp`` are (B, c, D, N).  Round s combines each step t >= s with
    step t - s, ``(a_d, a_i), (b_d, b_i) -> (a_d b_d, b_d a_i + b_i)``, so
    after log2(c) rounds step t holds the product of decays and the state
    from the chunk's start.  Returns every step's state."""
    c, s = da.shape[1], 1
    while s < c:   # out of place, so that autograd can run through it
        inp = torch.cat([inp[:, :s], torch.addcmul(inp[:, s:], da[:, s:], inp[:, :-s])], dim=1)
        da = torch.cat([da[:, :s], da[:, :-s] * da[:, s:]], dim=1)
        s *= 2
    return torch.addcmul(inp, da, h[:, None])


def mamba_apply(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Prefill / training forward.  x: (B, S, M) -> (B, S, M)."""
    x1, z = halves(x @ p["w_in"])                                # (B, S, D)
    x1 = constrain(x1, ("act_batch", "act_seq", "act_mlp"))
    x1 = F.silu(causal_conv1d(x1, p["conv_w"], p["conv_b"]))
    dt, Bs, Cs = _ssm_inputs(p, x1, cfg)
    A = -torch.exp(p["A_log"])                                   # (D, N)
    y = _scan_on_shards(dt, Bs, Cs, x1.float(), A, p["D"], cfg.mamba.chunk)
    return (y.to(x.dtype) * F.silu(z)) @ p["w_out"]


def _scan(dt, Bs, Cs, x1f, A, d_skip, chunk_len: int):
    """The chunked scan, f32: dt, x1f (B, S, D), Bs, Cs (B, S, N), A (D,
    N), the skip d_skip (D,) -> y (B, S, D).  On a dry run's fake tensors
    one chunk is traced and counted once a chunk (``roofline.TracedLoop``)."""
    B, S, D = dt.shape
    chunk = min(chunk_len, S)

    def step(carry, dtk, Bk, Ck, xk, A):
        da = torch.exp(dtk[..., None] * A)                       # (B, c, D, N)
        inp = (dtk * xk)[..., None] * Bk[:, :, None, :]
        h_all = _scan_chunk(da, inp, carry[0])
        return (h_all[:, -1],), torch.einsum("bcdn,bcn->bcd", h_all, Ck)

    def zero(distinct: bool):
        return (torch.zeros((B, D, A.shape[-1]), dtype=torch.float32, device=dt.device),)

    with torch.profiler.record_function("mamba_scan"):
        if isinstance(dt, FakeTensor) and S > chunk and S % chunk == 0:
            y = roofline.TracedLoop.apply(step, zero, 1, chunk, 4, dt, Bs, Cs, x1f, A)
        else:
            # ``split`` (one backward node a tensor), not a slice a chunk, whose
            # backward would write a full-size gradient a chunk
            carry, ys = zero(False), []
            for dtk, Bk, Ck, xk in zip(*(a.split(chunk, dim=1) for a in (dt, Bs, Cs, x1f))):
                pad = chunk - dtk.shape[1]
                if pad:   # the ragged last chunk, padded as the reference pads it
                    dtk, Bk, Ck, xk = (F.pad(a, (0, 0, 0, pad)) for a in (dtk, Bk, Ck, xk))
                carry, yk = step(carry, dtk, Bk, Ck, xk, A)
                ys.append(yk)
            y = torch.cat(ys, dim=1)[:, :S]
        return y + d_skip * x1f


def _scan_on_shards(dt, Bs, Cs, x1f, A, d_skip, chunk_len: int):
    """:func:`_scan`; under a mesh on each rank's shard (batch as
    ``act_batch``, d_inner as ``act_mlp``, the sequence whole), where it
    treats each (batch row, channel) alone: no DTensor op a chunk round."""
    mesh = active_mesh()
    if mesh is None or not isinstance(dt, DTensor):
        return _scan(dt, Bs, Cs, x1f, A, d_skip, chunk_len)
    act = placements_for(("act_batch", None, "act_mlp"), dt.shape, mesh)
    rows = [a if isinstance(a, Shard) and a.dim == 0 else Replicate() for a in act]
    chans = [Shard(0) if isinstance(a, Shard) and a.dim == 2 else Replicate() for a in act]
    # a gradient is a Partial sum over the mesh dims that cut the other operand
    rows_grad = [Partial() if isinstance(a, Shard) and a.dim == 2 else b for a, b in zip(act, rows)]
    chans_grad = [Partial() if isinstance(a, Shard) and a.dim == 0 else b
                  for a, b in zip(act, chans)]
    return local_map(lambda *t: _scan(*t, chunk_len), out_placements=act,
                     in_placements=(act, rows, rows, act, chans, chans),
                     in_grad_placements=(act, rows_grad, rows_grad, act, chans_grad, chans_grad),
                     device_mesh=mesh, redistribute_inputs=True)(dt, Bs, Cs, x1f, A, d_skip)


def init_mamba_state(cfg, batch: int, lead: tuple = (), device="cuda") -> dict:
    """Zero state: ``h`` (*lead, B, d_inner, N) f32 and the conv window
    (*lead, B, K - 1, d_inner) in the model dtype."""
    D, N, K = d_inner(cfg), cfg.mamba.d_state, cfg.mamba.d_conv
    return {"h": torch.zeros((*lead, batch, D, N), dtype=torch.float32, device=device),
            "conv": torch.zeros((*lead, batch, K - 1, D), dtype=pdtype(cfg), device=device)}


def mamba_decode(p: dict, x_t: torch.Tensor, state: dict, cfg):
    """One-token recurrent step.  x_t: (B, M) -> (out, new state)."""
    x1, z = halves(x_t @ p["w_in"])                              # (B, D)
    x1, conv_state = conv1d_step(x1, state["conv"], p["conv_w"], p["conv_b"])
    x1 = F.silu(x1)
    dt, Bs, Cs = _ssm_inputs(p, x1, cfg)                         # (B, D), (B, N), (B, N)
    da = torch.exp(dt[..., None] * -torch.exp(p["A_log"]))       # (B, D, N)
    x1f = x1.float()
    h = da * state["h"] + (dt * x1f)[..., None] * Bs[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, Cs) + p["D"] * x1f
    return (y.to(x_t.dtype) * F.silu(z)) @ p["w_out"], {"h": h, "conv": conv_state}
