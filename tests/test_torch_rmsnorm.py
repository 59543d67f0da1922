"""RMSNorm: the port's plain version (what the wrapper runs for CPU tensors)
against the JAX package's Pallas kernel run in interpret mode, on the same
numpy inputs.

Tolerances: float32 within 1e-5 (both sum the squares in f32, in different
orders); bfloat16 within one bf16 ulp of the reference (rtol 2**-7): the
inputs are the same bf16 values, the f32 results differ only in their last
bits, and the cast to bf16 can round them to neighbouring values.  The
kernel itself runs only on the card (``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm import rmsnorm as rmsnorm_jax
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2 ** -7, atol=1e-6)}


def _inputs(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * 3.0
    s = rng.standard_normal(shape[-1]).astype(np.float32)
    return x, s


# ragged: d below, at and past one 128-lane tile, rows not a multiple of 8
@pytest.mark.parametrize("shape", [(1, 3), (7, 130), (37, 257), (3, 5, 100), (16, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_jax_kernel(shape, dtype):
    x, s = _inputs(shape, dtype, sum(shape))
    ref = rmsnorm_jax(jnp.asarray(x, dtype), jnp.asarray(s, dtype), eps=1e-5, impl="kernel",
                      block_rows=8, interpret=True)
    xt = torch.from_numpy(x).to(_TORCH[dtype])
    st = torch.from_numpy(s).to(_TORCH[dtype])
    out = rmsnorm_plain(xt, st, eps=1e-5)
    assert out.dtype == xt.dtype and out.shape == xt.shape
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), **_TOL[dtype])


def test_rmsnorm_f32_scale_with_bf16_input_matches_jax():
    """A scale kept in f32 beside bf16 activations: cast to f32 either way."""
    x, s = _inputs((9, 200), "bfloat16", 5)
    ref = rmsnorm_jax(jnp.asarray(x, jnp.bfloat16), jnp.asarray(s), eps=1e-6, impl="kernel",
                      block_rows=8, interpret=True)
    out = rmsnorm(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(s), eps=1e-6)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               **_TOL["bfloat16"])


def test_rmsnorm_wrapper_takes_plain_version_on_cpu_without_launching():
    x, s = _inputs((4, 33), "float32", 1)
    xt, st = torch.from_numpy(x), torch.from_numpy(s)
    before = rmsnorm.launches
    out = rmsnorm(xt, st)
    assert rmsnorm.launches == before
    assert torch.equal(out, rmsnorm_plain(xt, st))
