"""Single-token KV-cache decode attention (GQA, ragged lengths).

Port of ``repro/kernels/decode_attention``.  :func:`decode_attention` takes
the reference wrapper's layout — q (B, Hq, D), caches (B, Smax, Hkv, D),
lengths (B,) — and launches the CUDA kernel of ``csrc/decode_attention.cu``
for tensors on the card.  :func:`decode_attention_plain` is the same
function in plain PyTorch; the wrapper uses it only for tensors on the CPU.

Contract (the kernel's, ``kernel.py:70-73`` of the reference): cache
entries at or past a row's length never affect the output, and a row of
length 0 gives 0 (the reference's dense oracle gives NaN there).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_MAX_GROUP = 8
_TILE = {torch.bfloat16: 64, torch.float32: 32}   # keys per shared-memory tile


def decode_attention_plain(q, k_cache, v_cache, lengths, *, scale: float | None = None):
    """q: (B, Hq, D); k/v_cache: (B, Smax, Hkv, D); lengths: (B,) -> (B, Hq, D)."""
    B, Hq, D = q.shape
    _, Smax, Hkv, _ = k_cache.shape
    g = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    qg = q.reshape(B, Hkv, g, D).float()
    logits = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float()) * scale
    valid = (torch.arange(Smax, device=q.device)[None, :]
             < lengths.to(q.device).long()[:, None])[:, None, None, :]
    logits = logits.masked_fill(~valid, -torch.inf)
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))   # length-0 rows
    p = torch.exp(logits - m)
    den = p.sum(dim=-1, keepdim=True)
    # never let a value past the length reach the product, even as 0 * inf
    out = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float().masked_fill(
        ~valid[:, 0, 0, :, None, None], 0.0))
    out = torch.where(den > 0, out / den.clamp_min(1e-30), torch.zeros_like(out))
    return out.reshape(B, Hq, D).to(q.dtype)


_TILES_PER_CHUNK = 8


def _split(smax: int, tile: int) -> tuple[int, int]:
    """Sequence chunk per block and number of chunks.  Chunks are short (8
    tiles), so a sequence's work spreads over many blocks and the blocks of
    chunks past its length exit at once: with ragged lengths the valid work
    is balanced over the SMs without the host reading the lengths."""
    chunk = _TILES_PER_CHUNK * tile
    return chunk, -(-smax // chunk)


def decode_attention(q, k_cache, v_cache, lengths, *, scale: float | None = None):
    """Decode attention; the CUDA kernel for tensors on the card, the plain
    version for tensors on the CPU.  ``decode_attention.launches`` counts
    kernel launches."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, lengths, scale=scale)
    B, Hq, D = q.shape
    Bk, Smax, Hkv, Dk = k_cache.shape
    for t in (k_cache, v_cache, lengths):
        if t.device != q.device:
            raise ValueError(f"decode_attention: tensors on {q.device} and {t.device}")
    if (Bk, Dk) != (B, D) or v_cache.shape != k_cache.shape or lengths.shape != (B,):
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k_cache.shape)}, v {tuple(v_cache.shape)}, "
                         f"lengths {tuple(lengths.shape)}")
    if q.dtype not in _DTYPE_CODE or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError(f"decode_attention: dtypes {q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if lengths.dtype != torch.int32:
        raise ValueError("decode_attention: lengths must be int32")
    if Hq % Hkv or Hq // Hkv > _MAX_GROUP or D != 128:
        raise ValueError(f"decode_attention: Hq={Hq}, Hkv={Hkv}, D={D} not supported")
    if not (q.is_contiguous() and k_cache.is_contiguous() and v_cache.is_contiguous()
            and lengths.is_contiguous()):
        raise ValueError("decode_attention: tensors must be contiguous")
    build.require_sm90(q)
    launch = build.load("decode_attention")
    g = Hq // Hkv
    chunk, n_split = _split(Smax, _TILE[q.dtype])
    out = torch.empty_like(q)
    part_acc = torch.empty((B * Hkv * n_split * g * D,), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((B * Hkv * n_split * g * 2,), dtype=torch.float32, device=q.device)
    err = launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
        B, Hq, Hkv, Smax, D, _DTYPE_CODE[q.dtype], n_split, chunk,
        ctypes.c_float(1.0 / (D ** 0.5) if scale is None else scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0

