"""The port's xLSTM family against the reference on the xlstm-125m smoke
config (d_model 64, 4 heads, one (mLSTM, sLSTM) pair, chunk 16), with the
reference's weights carried across by ``model_params_from_jax``.

S = 40 is not a multiple of the chunk, so the last chunk is padded.
Tolerances: f32 blocks and their decode steps atol 1e-5, rtol 1e-5 (the
same f32 math, sums in another order); the chunked form against the port's
own sequential oracle atol 2e-5 (a different summation of the same
recurrence); f32 model logits atol 2e-4, rtol 1e-4; the bf16 forward each
logits row within 3e-2 of its norm (each framework's bf16 logits lie up to
1.8e-2 from the f32 logits of the same weights: the two round SiLU, GELU
and the residual adds at different points)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import layers as jl, model as jm, xlstm as jx
from repro_torch.configs import get_config as t_config, get_smoke_config as t_smoke
from repro_torch.convert import model_params_from_jax
from repro_torch.models import layers as tl, model as tm, xlstm as tx

TOL = dict(atol=1e-5, rtol=1e-5)
B, S = 2, 40


def _cfgs(dtype="float32"):
    return (j_smoke("xlstm-125m").replace(dtype=dtype),
            t_smoke("xlstm-125m").replace(dtype=dtype))


@pytest.fixture(scope="module")
def carried():
    jcfg, tcfg = _cfgs()
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, model_params_from_jax(jax.device_get(jp), tcfg, "cpu")


def _pair(jp, tp, block):
    """The first pair's ``block`` params of both packages."""
    return (jax.tree.map(lambda a: a[0], jp["pairs"][block]),
            {k: v[0] for k, v in tp["pairs"][block].items()})


def _x(seed=0, shape=(B, S, 64)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_causal_conv_and_its_decode_step_match_reference():
    """Both forms, and the K = 1 edge where the step keeps its state."""
    rng = np.random.default_rng(1)
    for k in (4, 1):
        x = rng.normal(size=(2, 9, 6)).astype(np.float32)
        w = rng.normal(size=(k, 6)).astype(np.float32)
        b = rng.normal(size=(6,)).astype(np.float32)
        np.testing.assert_allclose(
            tl.causal_conv1d(*map(torch.from_numpy, (x, w, b))).numpy(),
            np.asarray(jl.causal_conv1d(*map(jnp.asarray, (x, w, b)))), **TOL)
        state = rng.normal(size=(2, max(k - 1, 1), 6)).astype(np.float32)
        yj, sj = jl.conv1d_step(*map(jnp.asarray, (x[:, 0], state, w, b)))
        yt, st = tl.conv1d_step(*map(torch.from_numpy, (x[:, 0], state, w, b)))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_mlstm_chunked_matches_reference_and_sequential_oracle(carried):
    jcfg, tcfg, jp, tp = carried
    pj, pt = _pair(jp, tp, "mlstm")
    x = _x()
    got = tx.mlstm_apply(pt, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(jx.mlstm_apply(pj, jnp.asarray(x), jcfg)),
                               **TOL)
    seq = tx.mlstm_sequential(pt, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), seq.numpy(), atol=2e-5, rtol=1e-5)


def test_slstm_matches_reference(carried):
    jcfg, tcfg, jp, tp = carried
    pj, pt = _pair(jp, tp, "slstm")
    x = _x(2)
    np.testing.assert_allclose(tx.slstm_apply(pt, torch.from_numpy(x), tcfg).numpy(),
                               np.asarray(jx.slstm_apply(pj, jnp.asarray(x), jcfg)), **TOL)


@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_block_decode_steps_match_reference(carried, block):
    """Six tokens through ``*_decode`` from the zero state: each output and
    the state after it."""
    jcfg, tcfg, jp, tp = carried
    pj, pt = _pair(jp, tp, block)
    init_j = getattr(jx, f"init_{block}_state")
    init_t = getattr(tx, f"init_{block}_state")
    dec_j, dec_t = getattr(jx, f"{block}_decode"), getattr(tx, f"{block}_decode")
    sj, st = init_j(jcfg, B), init_t(tcfg, B, device="cpu")
    assert sorted(st) == sorted(sj)
    for name in sj:
        assert tuple(st[name].shape) == sj[name].shape
    for i, x_t in enumerate(_x(3, (6, B, 64))):
        yj, sj = dec_j(pj, jnp.asarray(x_t), sj, jcfg)
        yt, st = dec_t(pt, torch.from_numpy(x_t), st, tcfg)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL, err_msg=f"step {i}")
        for name in sj:
            np.testing.assert_allclose(st[name].numpy(), np.asarray(sj[name]), **TOL,
                                       err_msg=f"step {i} {name}")


def test_model_prefill_and_decode_steps_match_reference(carried):
    """``prefill`` gives the last logits and a fresh zero cache (the
    reference's documented limitation); then ten ``decode_step``s."""
    jcfg, tcfg, jp, tp = carried
    tokens = np.random.default_rng(4).integers(0, jcfg.vocab_size, (B, 12)).astype(np.int32)
    lj, cj = jm.prefill(jp, jnp.asarray(tokens), jcfg, 12)
    lt, ct = tm.prefill(tp, torch.from_numpy(tokens), tcfg, 12)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=2e-4, rtol=1e-4)
    fresh = tm.init_cache(tp, tcfg, B, 12)
    for block in ("mlstm", "slstm"):
        for name, v in ct[block].items():
            assert tuple(v.shape) == cj[block][name].shape
            np.testing.assert_array_equal(v.numpy(), np.asarray(cj[block][name]))
            assert torch.equal(v, fresh[block][name])
    step = jax.jit(lambda p, c, t, q: jm.decode_step(p, c, t, q, jcfg))
    cj = jm.init_cache(jp, jcfg, B, 10)
    for t in range(10):
        pos = np.full((B,), t, np.int32)
        lj, cj = step(jp, cj, jnp.asarray(tokens[:, t]), jnp.asarray(pos))
        lt, ct = tm.decode_step(tp, ct, torch.from_numpy(tokens[:, t]), torch.from_numpy(pos),
                                tcfg)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=2e-4, rtol=1e-4,
                                   err_msg=f"step {t}")
    for block in ("mlstm", "slstm"):
        for name, v in ct[block].items():
            np.testing.assert_allclose(v.numpy(), np.asarray(cj[block][name]), atol=2e-4,
                                       rtol=1e-4, err_msg=f"{block}/{name}")


def test_bf16_forward_matches_reference_bf16():
    """The whole bf16 smoke model (bf16 weights, the f32 islands inside):
    logits of the parallel forward, row by row."""
    jcfg, tcfg = _cfgs("bfloat16")
    jp = jm.init_params(jcfg, jax.random.PRNGKey(1))
    tp = model_params_from_jax(jax.device_get(jp), tcfg, "cpu")
    tokens = np.random.default_rng(5).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    lj, _ = jm.forward_train(jp, {"tokens": jnp.asarray(tokens)}, jcfg)
    with torch.no_grad():
        lt, _ = tm.forward_train(tp, {"tokens": torch.from_numpy(tokens)}, tcfg)
    ref = np.asarray(lj, np.float32)
    assert lt.dtype == torch.float32 and lt.shape == ref.shape
    rel = np.linalg.norm(lt.numpy() - ref, axis=-1) / np.linalg.norm(ref, axis=-1)
    assert rel.max() <= 3e-2, rel.max()


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else tuple(v.shape) for k, v in tree.items()}


def test_init_params_shapes_dtypes_and_gate_biases():
    """``init_params`` makes every leaf ``param_shapes`` lists, the f32
    islands (gates, sLSTM weights, norms) in f32 and the rest in bf16; the
    forget-gate biases are ``linspace(3, 6)`` on every pair.  The full
    xlstm-125m has 172.98 M parameters."""
    cfg = t_smoke("xlstm-125m").replace(n_layers=4)
    p = tm.init_params(cfg, seed=0, device="cpu")
    assert _shapes(p) == tm.param_shapes(cfg)
    f32 = {"norm", "w_gates", "b_gates", "onorm", "slstm_w", "slstm_r", "slstm_b", "ffn_norm",
           "final_norm"}
    for block in ("mlstm", "slstm"):
        for name, v in p["pairs"][block].items():
            assert v.dtype == (torch.float32 if name in f32 else torch.bfloat16), name
    H, M = cfg.n_heads, cfg.d_model
    for i in range(2):
        torch.testing.assert_close(p["pairs"]["mlstm"]["b_gates"][i, H:],
                                   torch.linspace(3.0, 6.0, H))
        torch.testing.assert_close(p["pairs"]["slstm"]["slstm_b"][i, 2 * M:3 * M],
                                   torch.linspace(3.0, 6.0, M))
    # slstm_r: fan-in along its third axis, scaled by 0.5 (|r| <= 2 std)
    dh = M // H
    assert p["pairs"]["slstm"]["slstm_r"].abs().max() <= 0.5 * 2.0 / dh ** 0.5 + 1e-6
    assert not torch.equal(p["pairs"]["mlstm"]["wq"][0], p["pairs"]["mlstm"]["wq"][1])
    assert tm.count_params_analytic(t_config("xlstm-125m")) == 172_980_528
