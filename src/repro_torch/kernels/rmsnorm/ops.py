"""Fused RMSNorm over the last axis.

Port of ``repro/kernels/rmsnorm``, the public entry point
``repro.kernels.rmsnorm.rmsnorm``.  :func:`rmsnorm` takes x (..., d) and
scale (d,) and launches the CUDA kernel of ``csrc/rmsnorm.cu`` for tensors
on the card.  :func:`rmsnorm_plain` is the same function in plain PyTorch
(the semantics of ``repro/kernels/rmsnorm/ref.py: rmsnorm_ref``); the
wrapper uses it only for tensors on the CPU.

Semantics: the sum of squares in f32, ``rsqrt(mean + eps)``, times the scale
in f32, cast to x's type.  Any d and any row count: the kernel masks its own
ragged edges where the TPU wrapper padded d to 128 lanes and the rows to its
block.  No model calls this: ``models/layers.py: rmsnorm`` rounds its
multiply to the input type, as the reference model's norm does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """x: (..., d), scale: (d,) -> (..., d) in x's dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm; the CUDA kernel for tensors on the card, the plain version for
    tensors on the CPU.  ``rmsnorm.launches`` counts kernel launches."""
    if x.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps=eps)
    d = x.shape[-1] if x.dim() else 0
    if scale.device != x.device:
        raise ValueError(f"rmsnorm: tensors on {x.device} and {scale.device}")
    if x.dim() == 0 or scale.shape != (d,):
        raise ValueError(f"rmsnorm: shapes x {tuple(x.shape)}, scale {tuple(scale.shape)}")
    if x.dtype not in _DTYPE_CODE or scale.dtype not in (x.dtype, torch.float32):
        raise ValueError(f"rmsnorm: dtypes x {x.dtype}, scale {scale.dtype}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm: tensors must be contiguous")
    rows = x.numel() // d if d else 0
    if rows >= 2 ** 31 or d >= 2 ** 31:
        raise ValueError(f"rmsnorm: {rows} rows of {d} are more than the kernel indexes")
    build.require_sm90(x)
    launch = build.load("rmsnorm")
    out = torch.empty_like(x)
    if rows == 0:
        return out
    err = launch(x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d,
                 _DTYPE_CODE[x.dtype], _DTYPE_CODE[scale.dtype], ctypes.c_float(eps),
                 int(x.data_ptr() % 16 == out.data_ptr() % 16),
                 torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "rmsnorm")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
