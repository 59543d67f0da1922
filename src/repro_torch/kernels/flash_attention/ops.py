"""Forward flash attention (GQA, optional right-aligned causal mask).

Port of ``repro/kernels/flash_attention``.  :func:`flash_attention` takes
the reference wrapper's layout — q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D) —
and launches the CUDA kernel of ``csrc/flash_attention.cu`` for tensors on
the card: for bfloat16 the tensor cores (TMA loads and wgmma products, so
q, k, v and the output must start on a 16-byte boundary), for float32 the
CUDA cores.
:func:`flash_attention_plain` is the same function in plain PyTorch; the
wrapper uses it only for tensors on the CPU.

Contract: query i sits at position ``i + Skv - Sq`` (right-aligned, as a
prefill continuation), the kv head of q head h is ``h // (Hq // Hkv)``, and
a row with no visible key gives 0.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_Q_CHUNK = 2048   # query rows per dense product in the plain version


def flash_attention_plain(q, k, v, *, causal: bool = True, scale: float | None = None):
    """q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D).

    Dense f32 scores, one kv head and ``_Q_CHUNK`` query rows at a time so
    that a long prefill does not hold all (Sq, Skv) scores of every head."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    assert Hq % Hkv == 0, (Hq, Hkv)
    g = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    out = torch.empty((B, Sq, Hq, D), dtype=torch.float32, device=q.device)
    kpos = torch.arange(Skv, device=q.device)
    for h in range(Hkv):
        kh = k[:, :, h].float()                                   # (B, Skv, D)
        vh = v[:, :, h].float()
        for lo in range(0, Sq, _Q_CHUNK):
            hi = min(Sq, lo + _Q_CHUNK)
            qh = q[:, lo:hi, h * g:(h + 1) * g].float()           # (B, sq, g, D)
            logits = torch.einsum("bqgd,bkd->bgqk", qh, kh) * scale
            if causal:
                qpos = torch.arange(lo, hi, device=q.device)[:, None] + (Skv - Sq)
                logits = logits.masked_fill(~(qpos >= kpos[None, :]), -torch.inf)
            m = logits.amax(dim=-1, keepdim=True)
            m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))   # fully masked rows
            p = torch.exp(logits - m)
            den = p.sum(dim=-1, keepdim=True)
            o = torch.einsum("bgqk,bkd->bqgd", p / den.clamp_min(1e-30), vh)
            out[:, lo:hi, h * g:(h + 1) * g] = o
    return out.to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True, scale: float | None = None):
    """Flash attention; the CUDA kernel for tensors on the card, the plain
    version for tensors on the CPU.  ``flash_attention.launches`` counts
    kernel launches."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    B, Sq, Hq, D = q.shape
    Bk, Skv, Hkv, Dk = k.shape
    for t in (k, v):
        if t.device != q.device:
            raise ValueError(f"flash_attention: tensors on {q.device} and {t.device}")
    if (Bk, Dk) != (B, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if Hq % Hkv or D != 128 or Sq == 0 or Skv == 0:
        raise ValueError(f"flash_attention: Hq={Hq}, Hkv={Hkv}, D={D}, Sq={Sq}, Skv={Skv} "
                         "not supported")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: tensors must be contiguous")
    build.require_sm90(q)
    out = torch.empty_like(q)
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} does not start on a 16-byte boundary")
    launch = build.load("flash_attention")
    err = launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Skv, Hq, Hkv, D, _DTYPE_CODE[q.dtype], int(causal),
        ctypes.c_float(1.0 / (D ** 0.5) if scale is None else scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
