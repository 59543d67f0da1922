"""The port's Mamba block and the hybrid (Jamba) family against the
reference, on the jamba-v0.1-52b smoke config (one super-block of 8
sub-layers: attention at slot 4, Mamba elsewhere, MoE of 4 experts top-2
at the odd slots; d_model 64, d_state 8, chunks of 16) in float32, with
the reference's weights carried across by ``model_params_from_jax``.

Module outputs within 1e-4 of the reference's norm; logits within atol
2e-3, rtol 2e-2 (tests/test_models.py:88-89)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import mamba as jmb, model as jm
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.convert import model_params_from_jax
from repro_torch.models import mamba as tmb, model as tm

ARCH = "jamba-v0.1-52b"
NORM_TOL = 1e-4
LOGIT_TOL = dict(atol=2e-3, rtol=2e-2)
B = 2


def _cfgs():
    return tuple(f(ARCH).replace(dtype="float32") for f in (j_smoke, t_smoke))


@pytest.fixture(scope="module")
def carried():
    jcfg, tcfg = _cfgs()
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0))
    return jp, model_params_from_jax(jax.device_get(jp), tcfg, "cpu")


def _mamba0(jp, tp):
    """Sub-layer 0's Mamba params (block 0) of both packages."""
    return (jax.tree.map(lambda a: a[0], jp["blocks"]["sub0"]["mamba"]),
            {k: v[0] for k, v in tp["blocks"]["sub0"]["mamba"].items()})


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close_in_norm(got, ref, tol=NORM_TOL, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel <= tol, f"{what}: relative error {rel:.3e} above {tol:g}"


@pytest.mark.parametrize("S", [21, 37])   # chunks of 16: a ragged last chunk after 1 and 2
def test_mamba_apply_matches_reference(carried, S):
    jcfg, tcfg = _cfgs()
    pj, pt = _mamba0(*carried)
    x = _x((B, S, jcfg.d_model), S)
    _close_in_norm(tmb.mamba_apply(pt, torch.from_numpy(x), tcfg).numpy(),
                   jmb.mamba_apply(pj, jnp.asarray(x), jcfg), what=f"S={S}")


def test_mamba_chunked_scan_matches_its_decode_recurrence(carried):
    """The chunked scan's output at every step equals the O(1) recurrence
    run token by token from the zero state (the port against itself)."""
    _, tcfg = _cfgs()
    _, pt = _mamba0(*carried)
    x = torch.from_numpy(_x((B, 37, tcfg.d_model), 6))
    full = tmb.mamba_apply(pt, x, tcfg)
    state = tmb.init_mamba_state(tcfg, B, device="cpu")
    for t in range(x.shape[1]):
        y, state = tmb.mamba_decode(pt, x[:, t], state, tcfg)
        torch.testing.assert_close(y, full[:, t], atol=1e-5, rtol=1e-4)


def test_mamba_decode_steps_match_reference(carried):
    """Eight tokens through ``mamba_decode`` from the zero state: each
    output and the state after it."""
    jcfg, tcfg = _cfgs()
    pj, pt = _mamba0(*carried)
    sj, st = jmb.init_mamba_state(jcfg, B), tmb.init_mamba_state(tcfg, B, device="cpu")
    for name in sj:
        assert tuple(st[name].shape) == sj[name].shape
    for i, x_t in enumerate(_x((8, B, jcfg.d_model), 7)):
        yj, sj = jmb.mamba_decode(pj, jnp.asarray(x_t), sj, jcfg)
        yt, st = tmb.mamba_decode(pt, torch.from_numpy(x_t), st, tcfg)
        _close_in_norm(yt.numpy(), yj, what=f"step {i}")
        for name in sj:
            _close_in_norm(st[name].numpy(), sj[name], what=f"step {i} {name}")


def test_model_prefill_and_decode_steps_match_reference(carried):
    """``prefill`` gives the last logits and a fresh zero cache (the
    reference's documented limitation), in the reference's layout; then
    eight ``decode_step``s at ragged positions against the reference's."""
    jcfg, tcfg = _cfgs()
    jp, tp = carried
    S = 20
    tokens = np.random.default_rng(8).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    lj, cj = jm.prefill(jp, jnp.asarray(tokens), jcfg, S)
    lt, ct = tm.prefill(tp, torch.from_numpy(tokens), tcfg, S)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    for part in ("attn", "mamba"):
        for name, v in ct[part].items():
            assert tuple(v.shape) == cj[part][name].shape, (part, name)
            assert str(v.dtype).split(".")[1] == str(cj[part][name].dtype)
            assert not v.any()

    step = jax.jit(lambda p, c, t, q: jm.decode_step(p, c, t, q, jcfg))
    start = np.array([0, 5], np.int32)
    for t in range(8):
        pos = start + t
        lj, cj = step(jp, cj, jnp.asarray(tokens[:, t]), jnp.asarray(pos))
        lt, ct = tm.decode_step(tp, ct, torch.from_numpy(tokens[:, t]), torch.from_numpy(pos),
                                tcfg)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL, err_msg=f"step {t}")
    for part in ("attn", "mamba"):
        for name, v in ct[part].items():
            np.testing.assert_allclose(v.numpy(), np.asarray(cj[part][name]), **LOGIT_TOL,
                                       err_msg=f"{part}/{name}")


def test_loss_fn_forward_matches_reference(carried):
    """The loss with the MoE aux losses of the two MoE sub-layers; the drop
    fraction summed over them, equal to the last bit."""
    jcfg, tcfg = _cfgs()
    jp, tp = carried
    tokens = np.random.default_rng(9).integers(0, jcfg.vocab_size, (B, 40)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    totj, mj = jm.loss_fn(jp, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}, jcfg)
    tott, mt = tm.loss_fn(tp, {"tokens": torch.from_numpy(tokens),
                               "labels": torch.from_numpy(labels)}, tcfg)
    np.testing.assert_allclose(float(tott), float(totj), rtol=1e-5)
    for key in ("loss", "z_loss", "moe_aux", "tokens"):
        np.testing.assert_allclose(float(mt[key]), float(mj[key]), rtol=1e-5, err_msg=key)
    assert float(mt["moe_drop_frac"]) == float(mj["moe_drop_frac"])
