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

from repro_torch.models.layers import causal_conv1d, conv1d_step, dense_init, pdtype
from repro_torch.sharding import constrain


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
    dt_r, Bs, Cs = (x1 @ p["w_x"]).float().split([R, N, N], dim=-1)
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
    mc = cfg.mamba
    B, S, M = x.shape
    chunk = min(mc.chunk, S)

    x1, z = (x @ p["w_in"]).chunk(2, dim=-1)                     # (B, S, D)
    x1 = constrain(x1, ("act_batch", "act_seq", "act_mlp"))
    x1 = F.silu(causal_conv1d(x1, p["conv_w"], p["conv_b"]))
    dt, Bs, Cs = _ssm_inputs(p, x1, cfg)
    A = -torch.exp(p["A_log"])                                   # (D, N)
    x1f = x1.float()

    with torch.profiler.record_function("mamba_scan"):
        h = torch.zeros((B, d_inner(cfg), mc.d_state), dtype=torch.float32, device=x.device)
        ys = []
        for lo in range(0, S, chunk):
            dtk, Bk, Ck, xk = (a[:, lo:lo + chunk] for a in (dt, Bs, Cs, x1f))
            pad = chunk - dtk.shape[1]
            if pad:   # the ragged last chunk, padded as the reference pads it
                dtk, Bk, Ck, xk = (F.pad(a, (0, 0, 0, pad)) for a in (dtk, Bk, Ck, xk))
            da = torch.exp(dtk[..., None] * A)                   # (B, c, D, N)
            inp = (dtk * xk)[..., None] * Bk[:, :, None, :]
            h_all = _scan_chunk(da, inp, h)
            ys.append(torch.einsum("bcdn,bcn->bcd", h_all, Ck))
            h = h_all[:, -1]
        y = torch.cat(ys, dim=1)[:, :S] + p["D"] * x1f
    return (y.to(x.dtype) * F.silu(z)) @ p["w_out"]


def init_mamba_state(cfg, batch: int, lead: tuple = (), device="cuda") -> dict:
    """Zero state: ``h`` (*lead, B, d_inner, N) f32 and the conv window
    (*lead, B, K - 1, d_inner) in the model dtype."""
    D, N, K = d_inner(cfg), cfg.mamba.d_state, cfg.mamba.d_conv
    return {"h": torch.zeros((*lead, batch, D, N), dtype=torch.float32, device=device),
            "conv": torch.zeros((*lead, batch, K - 1, D), dtype=pdtype(cfg), device=device)}


def mamba_decode(p: dict, x_t: torch.Tensor, state: dict, cfg):
    """One-token recurrent step.  x_t: (B, M) -> (out, new state)."""
    x1, z = (x_t @ p["w_in"]).chunk(2, dim=-1)                   # (B, D)
    x1, conv_state = conv1d_step(x1, state["conv"], p["conv_w"], p["conv_b"])
    x1 = F.silu(x1)
    dt, Bs, Cs = _ssm_inputs(p, x1, cfg)                         # (B, D), (B, N), (B, N)
    da = torch.exp(dt[..., None] * -torch.exp(p["A_log"]))       # (B, D, N)
    x1f = x1.float()
    h = da * state["h"] + (dt * x1f)[..., None] * Bs[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, Cs) + p["D"] * x1f
    return (y.to(x_t.dtype) * F.silu(z)) @ p["w_out"], {"h": h, "conv": conv_state}
