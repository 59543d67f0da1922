"""The port's dense decoder against the reference on the llama3-8b smoke
config in float32, with the reference's weights carried across by
``model_params_from_jax`` (tolerances of tests/test_models.py:104)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import model as jm
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.convert import model_params_from_jax
from repro_torch.models import model as tm

KEY = jax.random.PRNGKey(0)


def _cfgs(arch="llama3-8b", **kw):
    return j_smoke(arch).replace(dtype="float32", **kw), t_smoke(arch).replace(dtype="float32", **kw)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.fixture(scope="module")
def carried():
    jcfg, tcfg = _cfgs()
    jp = jm.init_params(jcfg, KEY)
    return jcfg, tcfg, jp, model_params_from_jax(jax.device_get(jp), tcfg, "cpu")


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def test_prefill_matches_reference(carried):
    jcfg, tcfg, jp, tp = carried
    tokens = _tokens(jcfg, 2, 12)
    lj, cj = jm.prefill(jp, jnp.asarray(tokens), jcfg, 12)
    lt, ct = tm.prefill(tp, torch.from_numpy(tokens), tcfg, 12)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=2e-3, rtol=2e-2)
    for key in ("k", "v"):
        assert ct[key].shape == cj[key].shape
        np.testing.assert_allclose(ct[key].numpy(), np.asarray(cj[key]), atol=2e-3, rtol=2e-2)


def test_decode_steps_match_reference(carried):
    jcfg, tcfg, jp, tp = carried
    B, S = 2, 10
    tokens = _tokens(jcfg, B, S, seed=1)
    cj = jm.init_cache(jp, jcfg, B, S)
    ct = tm.init_cache(tp, tcfg, B, S)
    step = jax.jit(lambda p, c, t, q: jm.decode_step(p, c, t, q, jcfg))
    for t in range(S):
        lj, cj = step(jp, cj, jnp.asarray(tokens[:, t]), jnp.full((B,), t))
        lt, ct = tm.decode_step(tp, ct, torch.from_numpy(tokens[:, t]),
                                torch.full((B,), t, dtype=torch.int32), tcfg)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=2e-3, rtol=2e-2)
    for key in ("k", "v"):
        np.testing.assert_allclose(ct[key].numpy(), np.asarray(cj[key]), atol=2e-3, rtol=2e-2)


def test_ragged_decode_positions_match_reference(carried):
    """Rows at different positions: each writes its own cache slot."""
    jcfg, tcfg, jp, tp = carried
    B, Smax = 3, 16
    start = np.array([0, 5, 11], np.int32)
    tokens = _tokens(jcfg, B, 4, seed=2)
    cj = jm.init_cache(jp, jcfg, B, Smax)
    ct = tm.init_cache(tp, tcfg, B, Smax)
    for t in range(4):
        pos = start + t
        lj, cj = jm.decode_step(jp, cj, jnp.asarray(tokens[:, t]), jnp.asarray(pos), jcfg)
        lt, ct = tm.decode_step(tp, ct, torch.from_numpy(tokens[:, t]), torch.from_numpy(pos),
                                tcfg)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=2e-3, rtol=2e-2)
    np.testing.assert_allclose(ct["k"].numpy(), np.asarray(cj["k"]), atol=2e-3, rtol=2e-2)


def test_prefill_matches_decode_continuation():
    """The port's own prefill and decode agree (test_models.py's check)."""
    _, cfg = _cfgs()
    params = tm.init_params(cfg, seed=0, device="cpu")
    B, S = 2, 8
    tokens = torch.from_numpy(_tokens(cfg, B, S, seed=3))
    logits_p, cache_p = tm.prefill(params, tokens, cfg, S)
    cache = tm.init_cache(params, cfg, B, S)
    for t in range(S):
        logits_t, cache = tm.decode_step(params, cache, tokens[:, t],
                                         torch.full((B,), t, dtype=torch.int32), cfg)
    torch.testing.assert_close(logits_t, logits_p, atol=2e-3, rtol=2e-2)
    torch.testing.assert_close(cache["k"], cache_p["k"], atol=2e-3, rtol=2e-2)


def test_init_params_mirror_reference_tree():
    """Same keys, shapes and dtypes as the reference's params (bf16 config),
    and carrying bf16 weights across is exact."""
    jcfg, tcfg = j_smoke("qwen2.5-14b"), t_smoke("qwen2.5-14b")     # with qkv biases
    jp = jax.device_get(jm.init_params(jcfg, KEY))
    tp = tm.init_params(tcfg, seed=0, device="cpu")
    js = {k: (tuple(v.shape), str(v.dtype)) for k, v in _leaves(jp)}
    ts = {k: (tuple(v.shape), str(v.dtype).split(".")[1]) for k, v in _leaves(tp)}
    assert ts == js
    assert sum(v.numel() for _, v in _leaves(tp)) == tm.count_params_analytic(tcfg)
    carried = model_params_from_jax(jp, tcfg, "cpu")
    for k, v in _leaves(carried):
        ref = dict(_leaves(jp))[k]
        assert v.dtype == (torch.bfloat16 if str(ref.dtype) == "bfloat16" else torch.float32)
        np.testing.assert_array_equal(v.float().numpy(), np.asarray(ref, np.float32))


def test_other_families_are_refused():
    """Every family of the registry is ported: the audio (encoder-decoder)
    ``init_params`` tree has the reference's keys, shapes and dtypes (bf16
    config, traced without drawing; ``xattn`` without biases) and counts
    ``count_params_analytic`` parameters.  A family the reference does not
    have is refused."""
    arch = "seamless-m4t-large-v2"
    cfg = t_smoke(arch)
    got = {k: (tuple(v.shape), str(v.dtype).split(".")[1])
           for k, v in _leaves(tm.init_params(cfg, seed=0, device="cpu"))}
    ref = jax.eval_shape(lambda k: jm.init_params(j_smoke(arch), k), KEY)
    assert got == {k: (tuple(v.shape), str(v.dtype)) for k, v in _leaves(ref)}
    assert not any(k.startswith("dec_layers/xattn/b") for k in got)
    assert sum(int(np.prod(s)) for s, _ in got.values()) == tm.count_params_analytic(cfg)
    with pytest.raises(NotImplementedError):
        tm.init_params(cfg.replace(family="diffusion"), device="cpu")
