"""The bf16 decode kernel's split of the valid keys over its blocks
(``repro_torch/kernels/decode_attention/ops.py``: ``work_ranges``,
``pair_blocks``), which the CUDA code follows line for line.

Every valid key of every (batch, kv head) pair is covered exactly once, no
range starts at or past a length, pairs of length 0 get no work, block
shares differ by at most one tile, the workspace slots i + p of the
segments are distinct and inside the workspace, and the combine merges
exactly the blocks that wrote a partial of the pair.  Then the split and
the merge, done in float64 by the spec, give the JAX reference's decode
attention (tolerance 1e-5: the reference computes in float32)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention_ref as j_decode_ref
from repro_torch.kernels.decode_attention.ops import pair_blocks, pair_tiles, work_ranges

try:
    from hypothesis import given, strategies as st
except ImportError:  # pragma: no cover
    from _hypothesis_compat import given, st

TILE = 32


def _check_split(lengths, n_blocks, n_kv_heads, smax):
    ranges = work_ranges(lengths, n_blocks, TILE, n_kv_heads, smax)
    tiles = pair_tiles(lengths, n_kv_heads, smax, TILE)
    assert len(ranges) == n_blocks
    covered = [np.zeros(n, int) for n in tiles]
    slots = []
    for i, segs in enumerate(ranges):
        pairs = [p for p, _, _ in segs]
        assert pairs == sorted(set(pairs)), "one segment per pair, pairs in order"
        for p, a, b in segs:
            n = min(max(lengths[p // n_kv_heads], 0), smax)
            assert 0 <= a < b <= tiles[p]
            assert a * TILE < n, "a range starts before the length"
            covered[p][a:b] += 1
            slots.append(i + p)
    for p, c in enumerate(covered):
        assert np.all(c == 1), f"pair {p}: tiles covered {c.tolist()}"
        n = min(max(lengths[p // n_kv_heads], 0), smax)
        assert len(c) * TILE >= n > (len(c) - 1) * TILE or (n == 0 and len(c) == 0)
    shares = [sum(b - a for _, a, b in segs) for segs in ranges]
    assert max(shares) - min(shares) <= 1
    assert len(set(slots)) == len(slots), "two segments share a workspace slot"
    assert all(0 <= s < n_blocks + len(tiles) for s in slots)
    merged = pair_blocks(lengths, n_blocks, TILE, n_kv_heads, smax)
    for p in range(len(tiles)):
        wrote = [i for i, segs in enumerate(ranges) if any(q == p for q, _, _ in segs)]
        assert list(merged[p]) == wrote


@given(lengths=st.lists(st.integers(min_value=-3, max_value=400), min_size=1, max_size=6),
       n_blocks=st.integers(min_value=1, max_value=60),
       n_kv_heads=st.integers(min_value=1, max_value=4),
       smax=st.integers(min_value=1, max_value=360))
def test_work_ranges_cover_every_valid_key_once(lengths, n_blocks, n_kv_heads, smax):
    _check_split(lengths, n_blocks, n_kv_heads, smax)


@pytest.mark.parametrize("lengths,n_blocks,n_kv_heads,smax", [
    ([32760, 20001, 1, 12345], 396, 8, 32768),     # chip_smoke.py phase 1
    ([32760, 24577, 16001, 8191], 396, 8, 32768),  # the co-run pair
    ([396 * 32 - 1], 396, 1, 700 * 32 + 5),         # one pair over every block
    ([396 * 32], 396, 1, 700 * 32 + 5),
    ([396 * 32 + 1], 396, 1, 700 * 32 + 5),
    ([0, 0, 0], 7, 2, 100),                         # no valid key at all
    ([31, 32, 33, 0, 1, 1000], 320, 2, 1000),       # more blocks than tiles
    ([5000, 64], 3, 2, 4096),                       # lengths past Smax
])
def test_work_ranges_fixed_cases(lengths, n_blocks, n_kv_heads, smax):
    _check_split(lengths, n_blocks, n_kv_heads, smax)


def _split_and_merge(q, k, v, lengths, n_blocks, scale):
    """The kernel's algorithm in float64: per segment an online-softmax
    partial (m, l, acc) in the log2 domain, then each pair's partials merged."""
    B, Hq, D = q.shape
    _, smax, Hkv, _ = k.shape
    g = Hq // Hkv
    slots = {}
    for i, segs in enumerate(work_ranges(lengths, n_blocks, TILE, Hkv, smax)):
        for p, a, b in segs:
            bb, h = divmod(p, Hkv)
            n = min(lengths[bb], smax)
            keys = slice(a * TILE, min(b * TILE, n))
            s = (k[bb, keys, h] @ q[bb, h * g:(h + 1) * g].T).T * scale * np.log2(np.e)
            m = s.max(axis=1)
            e = np.exp2(s - m[:, None])
            slots[i + p] = (m, e.sum(axis=1), e @ v[bb, keys, h])
    out = np.zeros_like(q)
    for p, blocks in enumerate(pair_blocks(lengths, n_blocks, TILE, Hkv, smax)):
        bb, h = divmod(p, Hkv)
        if not blocks:
            continue
        parts = [slots[i + p] for i in blocks]
        M = np.max([m for m, _, _ in parts], axis=0)
        L = sum(np.exp2(m - M) * l for m, l, _ in parts)
        A = sum(np.exp2(m - M)[:, None] * acc for m, _, acc in parts)
        out[bb, h * g:(h + 1) * g] = A / L[:, None]
    return out


@pytest.mark.parametrize("lengths,n_blocks,group", [
    ([300, 1, 65, 128], 7, 4), ([300, 1, 65, 128], 40, 8), ([250], 9, 1), ([33, 96], 1, 2),
])
def test_split_and_merge_match_jax_reference(lengths, n_blocks, group):
    rng = np.random.default_rng(sum(lengths) + n_blocks)
    B, smax, Hkv, D = len(lengths), 320, 2, 16
    q = rng.standard_normal((B, Hkv * group, D))
    k = rng.standard_normal((B, smax, Hkv, D))
    v = rng.standard_normal((B, smax, Hkv, D))
    out = _split_and_merge(q, k, v, lengths, n_blocks, D ** -0.5)
    ref = np.asarray(j_decode_ref(*(jnp.asarray(a, jnp.float32) for a in (q, k, v)),
                                  jnp.asarray(lengths, jnp.int32)), np.float64)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    assert torch.from_numpy(out).isfinite().all()
