"""Shared layer primitives: init, RMSNorm, rotary embeddings, numerics policy.

Port of the parts of ``repro/models/layers.py`` the decoder families use
(all but the encoder-decoder's).
Random weights come from an explicit ``torch.Generator``; they do not
reproduce the reference's ``jax.random`` draws (weights are carried across
with :mod:`repro_torch.convert` where the two must agree).
"""
from __future__ import annotations

import math

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def pdtype(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# Initializers (explicit generators; params are plain dicts of tensors)
# ---------------------------------------------------------------------------

def _truncated_normal_(out: torch.Tensor, std: float, generator: torch.Generator) -> torch.Tensor:
    """Fill ``out`` with N(0, std²) truncated to ±2 std, drawn in f32 by
    inverting the normal CDF over the truncated range."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    u = torch.empty(out.shape, dtype=torch.float32, device=out.device)
    u.uniform_(lo, hi, generator=generator)
    x = u.mul_(2.0).sub_(1.0).erfinv_().mul_(math.sqrt(2.0) * std).clamp_(-2.0 * std, 2.0 * std)
    return out.copy_(x)


def dense_init(generator, shape, dtype, in_axis: int = 0,
               layers: int | tuple[int, ...] | None = None, device="cuda") -> torch.Tensor:
    """Truncated-normal fan-in init (stddev 1/sqrt(fan_in)).

    ``layers`` stacks independent draws on leading axes (the reference's
    vmapped per-layer init; a tuple such as ``(L, E)`` for a stack of
    expert matrices), filled one ``shape`` slice at a time so the f32
    scratch stays one slice large."""
    std = 1.0 / math.sqrt(max(1, shape[in_axis] if shape else 1))
    if layers is None:
        return _truncated_normal_(torch.empty(shape, dtype=dtype, device=device), std, generator)
    lead = (layers,) if isinstance(layers, int) else tuple(layers)
    out = torch.empty((*lead, *shape), dtype=dtype, device=device)
    for part in out.view(-1, *shape):
        _truncated_normal_(part, std, generator)
    return out


def embed_init(generator, shape, dtype, device="cuda") -> torch.Tensor:
    x = torch.empty(shape, dtype=torch.float32, device=device)
    x.normal_(0.0, 0.02, generator=generator)
    return x.to(dtype)


def ones_init(shape, dtype, device="cuda") -> torch.Tensor:
    return torch.ones(shape, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm as the reference has it: f32 only inside the variance
    reduction, the normalizing multiply in the input dtype (upcasting the
    whole tensor would change bf16 rounding)."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * scale.to(x.dtype)


def qk_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMS normalization of q or k over the last axis (Chameleon's
    QK-norm), in f32 and cast back to the input's dtype."""
    xf = x.float()
    return (xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    half = d_head // 2
    return theta ** (-torch.arange(0, half, dtype=torch.float32, device=device) / half)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    if theta <= 0:
        return x
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)            # (D/2,)
    angles = positions[..., None].float() * freqs             # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                     # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------

def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv over seq. x: (B, S, C); w: (K, C).

    The taps are unrolled, as in the reference (K is tiny, e.g. 4)."""
    k, S = w.shape[0], x.shape[1]
    pad = torch.nn.functional.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + pad[:, i:i + S, :] * w[i]
    if b is not None:
        out = out + b
    return out


def conv1d_step(x_t: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor | None):
    """One decode step of causal depthwise conv.

    x_t: (B, C); conv_state: (B, K-1, C) past inputs.  Returns
    ``(y_t, new_state)``; with K = 1 the state is returned as it came."""
    k = w.shape[0]
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)   # (B, K, C)
    y = torch.einsum("bkc,kc->bc", window, w)
    if b is not None:
        y = y + b
    return y, window[:, 1:, :] if k > 1 else conv_state
