"""The port's vlm family (a dense GQA decoder with QK-norm) against the
reference, on the chameleon-34b smoke config (d_model 64, 4/2 heads of 16)
in float32, with the reference's weights carried across by
``model_params_from_jax``; logits within atol 2e-3, rtol 2e-2
(tests/test_models.py:88-89).

It also pins a fault of the reference.  Its ``prefill``
(repro/models/model.py:209-231) rebuilds each layer's cache keys with
``_project_kv`` and RoPE but without the QK-norm its attention applied,
while ``attn_decode`` writes normed keys; so a decode step after a prefill
attends to raw keys and disagrees with teacher forcing.  The port's cache
holds the keys attention used (normed), and its continuation matches."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import layers as jl, model as jm
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.convert import model_params_from_jax
from repro_torch.models import layers as tl, model as tm

ARCH = "chameleon-34b"
LOGIT_TOL = dict(atol=2e-3, rtol=2e-2)
B, S = 2, 9


def _cfgs():
    return tuple(f(ARCH).replace(dtype="float32") for f in (j_smoke, t_smoke))


@pytest.fixture(scope="module")
def carried():
    jcfg, tcfg = _cfgs()
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    return jp, model_params_from_jax(jax.device_get(jp), tcfg, "cpu"), tokens


def _grow(cache, smax):
    """A prefill's S-slot cache grown to ``smax`` slots with zeros, as
    ``examples/serve_decode.py`` grows it to its horizon."""
    pad = ((0, 0), (0, 0), (0, smax - cache["k"].shape[2]), (0, 0), (0, 0))
    if isinstance(cache["k"], torch.Tensor):
        return {k: torch.from_numpy(np.pad(v.numpy(), pad)) for k, v in cache.items()}
    return {k: jnp.pad(v, pad) for k, v in cache.items()}


def test_qk_norm_matches_reference():
    x = np.random.default_rng(1).normal(size=(3, 5, 4, 16)).astype(np.float32) * 3.0
    np.testing.assert_allclose(tl.qk_norm(torch.from_numpy(x)).numpy(),
                               np.asarray(jl.qk_norm(jnp.asarray(x))), atol=1e-6, rtol=1e-6)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert tl.qk_norm(xb).dtype == torch.bfloat16


def test_prefill_logits_match_and_cache_holds_normed_keys(carried):
    """The logits equal the reference's; the cache V equals its V and the
    cache K equals ``qk_norm`` of its K (the reference stores raw keys)."""
    jcfg, tcfg = _cfgs()
    jp, tp, tokens = carried
    lj, cj = jm.prefill(jp, jnp.asarray(tokens), jcfg, S)
    lt, ct = tm.prefill(tp, torch.from_numpy(tokens), tcfg, S)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    np.testing.assert_allclose(ct["v"].numpy(), np.asarray(cj["v"]), **LOGIT_TOL)
    np.testing.assert_allclose(ct["k"].numpy(), np.asarray(jl.qk_norm(cj["k"])), **LOGIT_TOL)
    assert not np.allclose(ct["k"].numpy(), np.asarray(cj["k"]), **LOGIT_TOL)


def test_decode_steps_match_reference(carried):
    """From an empty cache both packages write normed keys: every step's
    logits and the cache agree."""
    jcfg, tcfg = _cfgs()
    jp, tp, tokens = carried
    cj, ct = jm.init_cache(jp, jcfg, B, S), tm.init_cache(tp, tcfg, B, S)
    step = jax.jit(lambda p, c, t, q: jm.decode_step(p, c, t, q, jcfg))
    for t in range(S):
        pos = np.full((B,), t, np.int32)
        lj, cj = step(jp, cj, jnp.asarray(tokens[:, t]), jnp.asarray(pos))
        lt, ct = tm.decode_step(tp, ct, torch.from_numpy(tokens[:, t]), torch.from_numpy(pos),
                                tcfg)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL, err_msg=f"step {t}")
    for key in ("k", "v"):
        np.testing.assert_allclose(ct[key].numpy(), np.asarray(cj[key]), **LOGIT_TOL)


def test_prefill_then_decode_matches_teacher_forcing_and_reference_does_not(carried):
    """Prefill the first S - 1 tokens, grow the cache and decode token S - 1:
    the port gives the last logits of a prefill of all S tokens; the
    reference, whose cache mixes raw and normed keys, does not (on these
    inputs it misses by 0.160, where the logits reach 0.630; the port by
    3e-7)."""
    jcfg, tcfg = _cfgs()
    jp, tp, tokens = carried
    pos = np.full((B,), S - 1, np.int32)
    last = tokens[:, S - 1]

    lt_full, _ = tm.prefill(tp, torch.from_numpy(tokens), tcfg, S)
    _, ct = tm.prefill(tp, torch.from_numpy(tokens[:, :S - 1]), tcfg, S - 1)
    lt, _ = tm.decode_step(tp, _grow(ct, S), torch.from_numpy(last), torch.from_numpy(pos), tcfg)
    np.testing.assert_allclose(lt.numpy(), lt_full.numpy(), **LOGIT_TOL)

    lj_full, _ = jm.prefill(jp, jnp.asarray(tokens), jcfg, S)
    _, cj = jm.prefill(jp, jnp.asarray(tokens[:, :S - 1]), jcfg, S - 1)
    lj, _ = jm.decode_step(jp, _grow(cj, S), jnp.asarray(last), jnp.asarray(pos), jcfg)
    miss = np.abs(np.asarray(lj) - np.asarray(lj_full)).max()
    assert miss > 0.05, f"the reference's continuation missed by only {miss:.3e}"
    assert np.abs(lt.numpy() - lt_full.numpy()).max() < miss / 20
