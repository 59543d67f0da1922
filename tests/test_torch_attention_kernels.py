"""The plain PyTorch versions of the port's attention kernels against the
reference's oracles and against its Pallas kernels run in interpret mode
(as ``tests/test_kernels.py`` runs them), over that file's parameter grid.
The CUDA kernels themselves are held against these plain versions on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as j_decode
from repro.kernels.decode_attention import decode_attention_ref as j_decode_ref
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.flash_attention import flash_attention_chunked as j_flash_chunked
from repro.kernels.flash_attention import flash_attention_ref as j_flash_ref
from repro_torch.kernels.decode_attention import decode_attention, decode_attention_plain
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

TOL = {"float32": 3e-5, "bfloat16": 3e-2}


def _both(x: np.ndarray, dtype: str):
    j = jnp.asarray(x, jnp.dtype(dtype))
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    return j, t


def _close(t_out, j_out, dtype):
    np.testing.assert_allclose(t_out.float().numpy(), np.asarray(j_out, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

DECODE_CASES = [  # B, Smax, Hkv, group, D
    (1, 4, 1, 1, 8), (2, 37, 2, 2, 32), (3, 300, 1, 8, 32), (4, 130, 2, 8, 8), (2, 65, 2, 1, 32),
]


@pytest.mark.parametrize("B,Smax,Hkv,group,D", DECODE_CASES)
def test_decode_plain_matches_reference(B, Smax, Hkv, group, D):
    rng = np.random.default_rng(B * 1000 + Smax)
    q = rng.standard_normal((B, Hkv * group, D)).astype(np.float32)
    k = rng.standard_normal((B, Smax, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Smax, Hkv, D)).astype(np.float32)
    lens = rng.integers(1, Smax + 1, B).astype(np.int32)
    args_j = [jnp.asarray(a) for a in (q, k, v, lens)]
    args_t = [torch.from_numpy(a) for a in (q, k, v, lens)]
    out = decode_attention(*args_t)                    # CPU tensors: the plain version
    _close(out, j_decode_ref(*args_j), "float32")
    _close(out, j_decode(*args_j, impl="kernel", block_k=64), "float32")


def test_decode_plain_bf16():
    rng = np.random.default_rng(7)
    B, Smax, Hkv, g, D = 3, 96, 2, 4, 32
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, Hkv * g, D), (B, Smax, Hkv, D), (B, Smax, Hkv, D)))
    lens = np.array([96, 40, 3], np.int32)
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, "bfloat16") for a in (q, k, v))
    out = decode_attention_plain(qt, kt, vt, torch.from_numpy(lens))
    _close(out, j_decode_ref(qj, kj, vj, jnp.asarray(lens)), "bfloat16")


def test_decode_values_past_length_are_inert():
    rng = np.random.default_rng(0)
    B, Smax, H, D = 2, 64, 2, 16
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Smax, H, D)).astype(np.float32)
    v = rng.standard_normal((B, Smax, H, D)).astype(np.float32)
    lens = np.array([10, 20], np.int32)
    k2, v2 = k.copy(), v.copy()
    k2[:, 30:], v2[:, 30:] = 99.0, -99.0
    k3, v3 = k.copy(), v.copy()
    k3[:, 20:], v3[:, 20:] = np.inf, np.nan       # even non-finite values stay out
    outs = [decode_attention_plain(*(torch.from_numpy(a) for a in (q, kk, vv, lens)))
            for kk, vv in ((k, v), (k2, v2), (k3, v3))]
    for o in outs[1:]:
        np.testing.assert_allclose(o.numpy(), outs[0].numpy(), atol=1e-6)
    ref = j_decode(*(jnp.asarray(a) for a in (q, k2, v2, lens)), impl="kernel", block_k=16)
    _close(outs[1], ref, "float32")


def test_decode_length_zero_gives_zero():
    """The kernel's contract: a row of length 0 gives 0 (the dense oracle
    gives NaN there, so the reference kernel is the one compared)."""
    rng = np.random.default_rng(5)
    B, Smax, Hkv, g, D = 3, 40, 2, 2, 8
    q = rng.standard_normal((B, Hkv * g, D)).astype(np.float32)
    k = rng.standard_normal((B, Smax, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Smax, Hkv, D)).astype(np.float32)
    lens = np.array([0, 17, 40], np.int32)
    out = decode_attention_plain(*(torch.from_numpy(a) for a in (q, k, v, lens)))
    assert torch.all(out[0] == 0)
    _close(out, j_decode(*(jnp.asarray(a) for a in (q, k, v, lens)), impl="kernel",
                         block_k=16), "float32")


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

FLASH_CASES = [  # B, Sq, extra_kv, Hkv, group, D, causal
    (1, 1, 0, 1, 1, 8, True), (2, 33, 10, 2, 2, 16, True), (3, 70, 40, 1, 4, 32, False),
    (2, 64, 0, 2, 4, 32, True),
]


def _qkv(rng, B, Sq, Skv, Hq, Hkv, D):
    return (rng.standard_normal((B, Sq, Hq, D)).astype(np.float32),
            rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32))


@pytest.mark.parametrize("B,Sq,extra_kv,Hkv,group,D,causal", FLASH_CASES)
def test_flash_plain_matches_reference(B, Sq, extra_kv, Hkv, group, D, causal):
    rng = np.random.default_rng(Sq * 100 + extra_kv)
    arrs = _qkv(rng, B, Sq, Sq + extra_kv, Hkv * group, Hkv, D)
    args_j = [jnp.asarray(a) for a in arrs]
    out = flash_attention(*(torch.from_numpy(a) for a in arrs), causal=causal)
    _close(out, j_flash_ref(*args_j, causal=causal), "float32")
    _close(out, j_flash_chunked(*args_j, causal=causal, block_k=16), "float32")
    _close(out, j_flash(*args_j, causal=causal, impl="kernel", block_q=32, block_k=32,
                        interpret=True), "float32")


def test_flash_plain_bf16():
    rng = np.random.default_rng(0)
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, "bfloat16") for a in _qkv(rng, 2, 64, 64, 4, 2, 32))
    out = flash_attention_plain(qt, kt, vt, causal=True)
    _close(out, j_flash_ref(qj, kj, vj, causal=True), "bfloat16")
    _close(out, j_flash(qj, kj, vj, causal=True, impl="kernel", block_q=32, block_k=32,
                        interpret=True), "bfloat16")


def test_flash_fully_masked_rows_give_zero():
    """Sq > Skv under the right-aligned causal mask: the first Sq - Skv
    queries see no key and give 0, the contract of the reference kernel
    (kernel.py:86-87).  The reference Pallas kernel breaks it for such rows
    that share a q block with rows that do see keys: its finite -1e30 mask
    becomes uniform weights there, and those rows get the mean of the first
    kv block's V.  The port keeps the contract; elsewhere the two agree."""
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 1, 40, 20, 2, 1, 16)
    out = flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)), causal=True).numpy()
    assert np.all(out[:, :20] == 0)
    ref = np.asarray(j_flash_ref(*(jnp.asarray(a) for a in (q, k, v)), causal=True))
    np.testing.assert_allclose(out[:, 20:], ref[:, 20:], atol=3e-5, rtol=3e-5)
    kern = np.asarray(j_flash(*(jnp.asarray(a) for a in (q, k, v)), causal=True, impl="kernel",
                              block_q=16, block_k=16, interpret=True))
    np.testing.assert_allclose(out[:, :16], kern[:, :16], atol=3e-5, rtol=3e-5)
    np.testing.assert_allclose(out[:, 20:], kern[:, 20:], atol=3e-5, rtol=3e-5)
    v_mean = v[0, :16, 0].mean(axis=0)
    np.testing.assert_allclose(kern[0, 16:20], np.broadcast_to(v_mean, (4, 2, 16)), atol=1e-5)


def test_flash_plain_chunks_long_queries():
    """Query chunking in the plain version changes nothing."""
    import repro_torch.kernels.flash_attention.ops as ops

    rng = np.random.default_rng(9)
    arrs = [torch.from_numpy(a) for a in _qkv(rng, 1, 50, 61, 4, 2, 8)]
    full = flash_attention_plain(*arrs, causal=True)
    old, ops._Q_CHUNK = ops._Q_CHUNK, 7
    try:
        chunked = flash_attention_plain(*arrs, causal=True)
    finally:
        ops._Q_CHUNK = old
    torch.testing.assert_close(chunked, full)
