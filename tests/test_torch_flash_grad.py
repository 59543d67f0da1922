"""Gradients of the port's flash attention (the autograd Function, whose
backward is ``flash_attention_bwd``) on CPU tensors against ``jax.grad`` of
the reference's ``flash_attention_chunked`` (what the reference lowers off
the TPU; XLA differentiates its scan), in f32 on the same numpy inputs.

The backward's query blocks are cut to 16 rows, so every case spans
several blocks and most end on a partial one.  All reference gradients come
from one jitted function (one JAX compile).  Tolerance: rtol 1e-4, atol
2e-5 (f32 sums over at most 56 keys and 4 heads in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import flash_attention_chunked
from repro_torch.kernels.flash_attention import flash_attention, ops

TOL = dict(rtol=1e-4, atol=2e-5)
# (name, B, Sq, Skv, Hq, Hkv, causal); D = 16
CASES = [
    ("g2_causal_square", 2, 40, 40, 4, 2, True),
    ("g4_full_square", 1, 40, 40, 8, 2, False),
    ("g2_causal_sq_lt_skv", 2, 24, 56, 4, 2, True),
    ("g2_full_sq_lt_skv", 1, 24, 56, 4, 2, False),
    ("g4_causal_sq_gt_skv", 1, 56, 24, 4, 1, True),       # rows 0..31 see no key
    ("g4_full_sq_gt_skv", 2, 56, 24, 8, 2, False),
]
D = 16


def _inputs(case, seed):
    _, B, Sq, Skv, Hq, Hkv, _ = case
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D), (B, Sq, Hq, D))]


@pytest.fixture(scope="module")
def reference():
    inputs = [_inputs(c, i) for i, c in enumerate(CASES)]

    def grads(all_inputs):
        out = []
        for case, (q, k, v, dout) in zip(CASES, all_inputs):
            causal = case[-1]

            def f(q, k, v):
                return jnp.sum(flash_attention_chunked(q, k, v, causal=causal) * dout)

            out.append(jax.grad(f, argnums=(0, 1, 2))(q, k, v))
        return out

    return inputs, [[np.asarray(g) for g in gs] for gs in jax.jit(grads)(inputs)]


@pytest.mark.parametrize("idx", range(len(CASES)), ids=[c[0] for c in CASES])
def test_grads_match_reference(reference, idx, monkeypatch):
    monkeypatch.setattr(ops, "_BWD_Q_CHUNK", 16)
    inputs, ref = reference
    q, k, v, dout = (torch.from_numpy(a) for a in inputs[idx])
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    out = flash_attention(q, k, v, causal=CASES[idx][-1])
    got = torch.autograd.grad(out, (q, k, v), dout)
    for name, g, r in zip("qkv", got, ref[idx]):
        assert np.isfinite(r).all(), f"reference d{name} is not finite"
        np.testing.assert_allclose(g.numpy(), r, **TOL, err_msg=f"d{name}")


def test_rows_without_keys_get_zero_grads(reference, monkeypatch):
    """Sq > Skv, causal: query i sits at i + Skv - Sq, so rows i < Sq - Skv
    see no key.  Their dq is exactly 0 in the port and in the reference
    (so the reference has no fault there); the forward gives 0 for them, so
    they add nothing to dk and dv."""
    monkeypatch.setattr(ops, "_BWD_Q_CHUNK", 16)
    idx = [c[0] for c in CASES].index("g4_causal_sq_gt_skv")
    _, _, Sq, Skv, _, _, _ = CASES[idx]
    inputs, ref = reference
    q, k, v, dout = (torch.from_numpy(a) for a in inputs[idx])
    q.requires_grad_(True)
    out = flash_attention(q, k, v, causal=True)
    dq, = torch.autograd.grad(out, (q,), dout)
    blind = Sq - Skv
    assert torch.all(out[:, :blind] == 0)
    assert torch.all(dq[:, :blind] == 0)
    assert np.all(ref[idx][0][:, :blind] == 0)
    # row ``blind`` sees one key (P = 1, so dq = 0 up to rounding); later rows
    # see more and get real gradients
    assert torch.all(dq[:, blind + 1:].abs().sum(dim=-1) > 1e-3)


def test_bwd_alone_and_dtypes():
    """``flash_attention_bwd`` called directly equals the Function's
    gradients, returns the inputs' dtypes, and without grad the wrapper
    builds no graph."""
    rng = np.random.default_rng(9)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                     for s in ((1, 20, 4, D), (1, 30, 2, D), (1, 30, 2, D), (1, 20, 4, D)))
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = flash_attention(qg, kg, vg)
    assert out.grad_fn is not None
    auto = torch.autograd.grad(out, (qg, kg, vg), dout)
    direct = ops.flash_attention_bwd(q, k, v, out.detach(), dout, True, None)
    for a, b in zip(auto, direct):
        assert torch.equal(a, b)
    with torch.no_grad():
        assert flash_attention(qg, kg, vg).grad_fn is None
    bf = [t.to(torch.bfloat16) for t in (q, k, v)]
    o = flash_attention(*bf)
    assert all(g.dtype == torch.bfloat16
               for g in ops.flash_attention_bwd(*bf, o, dout.to(torch.bfloat16), True, None))
