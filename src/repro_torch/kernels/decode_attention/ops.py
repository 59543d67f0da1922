"""Single-token KV-cache decode attention (GQA, ragged lengths).

Port of ``repro/kernels/decode_attention``.  :func:`decode_attention` takes
the reference wrapper's layout — q (B, Hq, D), caches (B, Smax, Hkv, D),
lengths (B,) — and launches the CUDA kernel of ``csrc/decode_attention.cu``
for tensors on the card, with heads of 64 or 128.
:func:`decode_attention_plain` is the same function in plain PyTorch; the
wrapper uses it only for tensors on the CPU.

Contract (the kernel's, ``kernel.py:70-73`` of the reference): cache
entries at or past a row's length are never read and never affect the
output, and a row of length 0 gives 0 (the reference's dense oracle gives
NaN there).

The bf16 kernel spreads the valid keys evenly over its blocks, a rule the
device applies to the lengths it reads itself: :func:`work_ranges` and
:func:`pair_blocks` below are that rule's spec, which the CUDA code follows.
The wrapper reports the kernel's flops and bytes to an active
``repro_torch.launch.roofline.CostCounter`` (:func:`decode_cost`); on fake
tensors it returns an empty output and computes nothing.
The wrapper reads nothing back from the card and sizes its workspace from
the shapes alone, so a decode step can be captured in a CUDA graph.
"""
from __future__ import annotations

import ctypes

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor

from repro_torch.kernels import build
from repro_torch.launch import roofline

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_MAX_GROUP = 8
_HEAD_SIZES = (64, 128)   # the kernel's D: seamless-m4t's heads and the others'
_TILE = {torch.bfloat16: 32, torch.float32: 32}   # keys per shared-memory tile


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
# bf16 blocks resident on an SM, by head size: a block's ring (3 stages of a
# 32-row K and V tile) is 51 KB at D = 128 and 27 KB at D = 64.  At D = 64,
# 8 blocks an SM measured 0.0619 ms against 4 blocks' 0.0811 at seamless's
# cross-attention decode shape (tools/kernel_variants.py --d64, H100 80GB HBM3)
_BLOCKS_PER_SM = {128: 4, 64: 8}


def _split(smax: int, tile: int) -> tuple[int, int]:
    """float32: sequence chunk per block and number of chunks.  Chunks are
    short (8 tiles), so a sequence's work spreads over many blocks and the
    blocks of chunks past its length exit at once."""
    chunk = _TILES_PER_CHUNK * tile
    return chunk, -(-smax // chunk)


def pair_tiles(lengths, n_kv_heads: int, smax: int, tile: int) -> list[int]:
    """Tiles of valid keys of each (batch, kv head) pair, pair p = b * Hkv + h."""
    out = []
    for n in lengths:
        out += [-(-min(max(int(n), 0), smax) // tile)] * n_kv_heads
    return out


def block_of(t: int, total: int, n_blocks: int) -> int:
    """The block whose share holds tile ``t`` of the ``total`` valid tiles."""
    return ((t + 1) * n_blocks - 1) // total


def work_ranges(lengths, n_blocks: int, tile: int, n_kv_heads: int, smax: int):
    """The bf16 kernel's split, decided on the device from ``lengths``.

    The valid tiles of all (batch, kv head) pairs, pair after pair, are
    numbered 0 .. T - 1; block i takes tiles [i T // n_blocks,
    (i + 1) T // n_blocks), whole tiles only, so shares differ by at most
    one tile.  A share may run from one pair into the next: it then has one
    segment per pair, and writes one partial (m, l, acc) per segment, to
    slot i + p of the workspace (i + p grows along the shares, so no two
    segments share a slot).  Returns, per block, its segments as
    ``(pair, first tile, end tile)`` with tiles counted inside the pair.
    """
    tiles = pair_tiles(lengths, n_kv_heads, smax, tile)
    total = sum(tiles)
    starts = [sum(tiles[:p]) for p in range(len(tiles))]
    out = []
    for i in range(n_blocks):
        lo, hi = i * total // n_blocks, (i + 1) * total // n_blocks
        segs = []
        for p, (s, n) in enumerate(zip(starts, tiles)):
            a, b = max(lo, s), min(hi, s + n)
            if a < b:
                segs.append((p, a - s, b - s))
        out.append(segs)
    return out


def pair_blocks(lengths, n_blocks: int, tile: int, n_kv_heads: int, smax: int):
    """For each pair, the blocks whose partials the combine pass merges:
    those of ``block_of(first tile) .. block_of(last tile)`` whose share is
    not empty (with more blocks than tiles, some shares are), none for a
    pair with no valid key (whose output is 0)."""
    tiles = pair_tiles(lengths, n_kv_heads, smax, tile)
    total, start, out = sum(tiles), 0, []
    for n in tiles:
        blocks = range(block_of(start, total, n_blocks),
                       block_of(start + n - 1, total, n_blocks) + 1) if n else range(0)
        out.append([i for i in blocks if i * total // n_blocks < (i + 1) * total // n_blocks])
        start += n
    return out


def grid_blocks(device, n_pairs: int, smax: int, d: int) -> int:
    """Blocks of the bf16 split kernel at head size ``d``: one wave of
    ``_BLOCKS_PER_SM[d]`` a multiprocessor, and no more than the tiles the
    cache could hold."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(_BLOCKS_PER_SM[d] * sms, n_pairs * -(-smax // _TILE[torch.bfloat16])))


def decode_cost(q, k_cache, lengths) -> tuple[float, float]:
    """``(flops, bytes)`` of one kernel call, counted over every cache slot
    (the lengths are device values): ``4 D`` a slot and q head, q, both
    caches and the lengths read once, the output written once."""
    B, Hq, D = q.shape
    flops = 4.0 * B * Hq * D * k_cache.shape[1]
    return flops, (2.0 * q.numel() * q.element_size() + 2.0 * k_cache.numel()
                   * k_cache.element_size() + lengths.numel() * lengths.element_size())


def decode_attention(q, k_cache, v_cache, lengths, *, scale: float | None = None):
    """Decode attention; the CUDA kernel for tensors on the card, the plain
    version for tensors on the CPU, an empty output for fake tensors.
    ``decode_attention.launches`` counts kernel launches."""
    return roofline.kernel_call("decode_attention", lambda: decode_cost(q, k_cache, lengths),
                                _decode_run, q, k_cache, v_cache, lengths, scale)


def _decode_run(q, k_cache, v_cache, lengths, scale):
    if isinstance(q, FakeTensor):
        return torch.empty_like(q)
    if isinstance(q, DTensor):
        raise TypeError("decode_attention: the kernel takes one rank's local tensors, "
                        "not a DTensor")
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
    if Hq % Hkv or Hq // Hkv > _MAX_GROUP or D not in _HEAD_SIZES:
        raise ValueError(f"decode_attention: Hq={Hq}, Hkv={Hkv}, D={D} not supported")
    if not (q.is_contiguous() and k_cache.is_contiguous() and v_cache.is_contiguous()
            and lengths.is_contiguous()):
        raise ValueError("decode_attention: tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError("decode_attention: q and the caches must start on 16-byte boundaries")
    build.require_sm90(q)
    launch = build.load("decode_attention")
    g = Hq // Hkv
    if q.dtype == torch.bfloat16:
        # n_split blocks, slot i + p of block i's segment of pair p
        n_split, chunk = grid_blocks(q.device, B * Hkv, Smax, D), _TILE[q.dtype]
        slots = n_split + B * Hkv
    else:
        chunk, n_split = _split(Smax, _TILE[q.dtype])
        slots = B * Hkv * n_split
    out = torch.empty_like(q)
    part_acc = torch.empty((slots * g * D,), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((slots * g * 2,), dtype=torch.float32, device=q.device)
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

