"""The port's audio (encoder-decoder) family against the reference, on the
seamless-m4t-large-v2 smoke config (d_model 64, 4/4 heads of 16, 2 + 2
layers) in float32, with the reference's weights from
``jax.random.PRNGKey(0)`` carried across by ``model_params_from_jax`` and
inputs from numpy seeds.  The reference runs as its own tests run it on the
CPU (``attn_impl="auto"``: the chunked flash form and the decode oracle);
one JAX compile (the jitted decode step).

Tolerances: layer outputs and the cross K/V within 1e-5 (f32 sums in
another order: the reference's chunked online softmax against the port's
dense one); logits and the loss within tests/test_models.py's atol 2e-3,
rtol 2e-2; teacher forcing within 1e-4 row relative (chip_smoke.py's f32
row bound).

It also pins the reference's padding semantics, which the port follows
(ROADMAP.md §3): the encoder attends over every frame, padding included,
and teacher forcing's cross-attention reads all Se frames, while the
cross-attention decode step masks frames at or past ``enc_lens``.  So a
decode continuation matches ``forward_train`` at ``enc_lens == Se`` and
does not at ``enc_lens < Se``, in both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.kernels.decode_attention import decode_attention_ref as j_decode_ref
from repro.kernels.flash_attention import flash_attention_ref as j_flash_ref
from repro.models import encdec as je, layers as jl, mlp as jmlp, model as jm
from repro_torch.configs import SHAPES, get_smoke_config as t_smoke, scaled_shape
from repro_torch.convert import model_params_from_jax
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models import encdec as te, mlp as tmlp, model as tm
from repro_torch.models.transformer import layer_params
from repro_torch.runtime.steps import make_decode_step, make_prefill_step

ARCH = "seamless-m4t-large-v2"
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=2e-3, rtol=2e-2)
TF_TOL = 1e-4          # teacher forcing, row relative
B, S, SE = 2, 8, 16    # tokens, and frames (the smoke config's enc_len)
RAGGED = np.array([11, 6], np.int32)    # enc_lens < Se
STEPS = 6


def _cfgs():
    return tuple(f(ARCH).replace(dtype="float32") for f in (j_smoke, t_smoke))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _row_rel(got, ref) -> float:
    got, ref = _np(got).reshape(-1, _np(got).shape[-1]), _np(ref).reshape(-1, _np(ref).shape[-1])
    return float((np.linalg.norm(got - ref, axis=-1) / np.linalg.norm(ref, axis=-1)).max())


@pytest.fixture(scope="module")
def carried():
    jcfg, tcfg = _cfgs()
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    frames = rng.standard_normal((B, SE, jcfg.d_model)).astype(np.float32)
    return jp, model_params_from_jax(jax.device_get(jp), tcfg, "cpu"), tokens, frames


@pytest.fixture(scope="module")
def j_decode():
    jcfg, _ = _cfgs()
    return jax.jit(lambda p, c, t, q: jm.decode_step(p, c, t, q, jcfg))


def _j_cache(jp, frames, enc_lens):
    """The reference's prefill step, written out: encoder, enc_norm, cache."""
    jcfg, _ = _cfgs()
    enc = je.encoder_apply(jp["enc_layers"], jnp.asarray(frames), jcfg, jnp.arange(SE)[None, :])
    enc = jl.rmsnorm(enc, jp["enc_norm"], jcfg.norm_eps)
    return je.init_encdec_cache(jp, jcfg, B, S, enc, jnp.asarray(enc_lens))


def _t_cache(tp, frames, enc_lens):
    _, tcfg = _cfgs()
    shape = scaled_shape(SHAPES["decode_32k"], 128 // B, 32768 // S)    # B x S self slots
    return make_prefill_step(tcfg, shape, device="cpu")(tp, torch.from_numpy(frames),
                                                        torch.from_numpy(enc_lens))


def _decode(step, params, cache, tokens, *, jax_side: bool):
    """Decode tokens 0 .. STEPS - 1 one at a time; each step's logits."""
    out = []
    for t in range(STEPS):
        pos = np.full((B,), t, np.int32)
        if jax_side:
            logits, cache = step(params, cache, jnp.asarray(tokens[:, t]), jnp.asarray(pos))
        else:
            logits, cache = step(params, cache, torch.from_numpy(tokens[:, t]),
                                 torch.from_numpy(pos))
        out.append(_np(logits))
    return np.stack(out, 1)


def test_gelu_mlp_and_layers_match_reference(carried):
    jcfg, tcfg = _cfgs()
    jp, tp, tokens, frames = carried
    x = np.random.default_rng(1).standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    jl0, tl0 = (jax.tree.map(lambda a: a[0], jp["dec_layers"]),
                layer_params(tp["dec_layers"], 0))
    np.testing.assert_allclose(_np(tmlp.gelu_mlp_apply(tl0["mlp"], torch.from_numpy(x))),
                               _np(jmlp.gelu_mlp_apply(jl0["mlp"], jnp.asarray(x))), **LAYER_TOL)

    enc_pos = np.arange(SE)[None, :]
    je0 = jax.tree.map(lambda a: a[0], jp["enc_layers"])
    j_enc = je.enc_layer_apply(je0, jnp.asarray(frames), jcfg, jnp.asarray(enc_pos))
    t_enc = te.enc_layer_apply(layer_params(tp["enc_layers"], 0), torch.from_numpy(frames), tcfg,
                               torch.from_numpy(enc_pos))
    np.testing.assert_allclose(_np(t_enc), _np(j_enc), **LAYER_TOL)

    pos = np.arange(S)[None, :]
    j_dec = je.dec_layer_apply(jl0, jnp.asarray(x), j_enc, jcfg, jnp.asarray(pos))
    t_dec = te.dec_layer_apply(tl0, torch.from_numpy(x), t_enc, tcfg, torch.from_numpy(pos))
    np.testing.assert_allclose(_np(t_dec), _np(j_dec), **LAYER_TOL)


def test_forward_train_and_loss_match_reference(carried):
    jcfg, tcfg = _cfgs()
    jp, tp, tokens, frames = carried
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels),
          "frames": jnp.asarray(frames)}
    tb = {k: torch.from_numpy(v) for k, v in
          (("tokens", tokens), ("labels", labels), ("frames", frames))}
    jlog, _ = jm.forward_train(jp, jb, jcfg)
    with torch.no_grad():
        tlog, aux = tm.forward_train(tp, tb, tcfg)
        tloss, tmet = tm.loss_fn(tp, tb, tcfg)
    np.testing.assert_allclose(_np(tlog), _np(jlog), **LOGIT_TOL)
    jloss, jmet = jm.loss_fn(jp, jb, jcfg)
    np.testing.assert_allclose(tloss.item(), float(jloss), **LOGIT_TOL)
    for k in ("loss", "z_loss", "tokens"):
        np.testing.assert_allclose(tmet[k].item(), float(jmet[k]), **LOGIT_TOL, err_msg=k)
    assert all(v.item() == 0 for v in aux.values())
    with pytest.raises(NotImplementedError):       # the prefill is the serve step's encoder pass
        tm.prefill(tp, torch.from_numpy(tokens), tcfg, S)


def test_prefill_step_cross_kv_matches_reference(carried):
    """At ragged enc_lens < Se: the cross K/V of every layer, the lengths
    stacked per layer as the reference's vmap leaves them, a zero self
    cache of S slots."""
    jp, tp, tokens, frames = carried
    jc, tc = _j_cache(jp, frames, RAGGED), _t_cache(tp, frames, RAGGED)
    for key in ("k", "v"):
        assert tc["cross"][key].shape == jc["cross"][key].shape
        np.testing.assert_allclose(_np(tc["cross"][key]), _np(jc["cross"][key]), **LAYER_TOL)
        assert tc["self"][key].shape == jc["self"][key].shape and not tc["self"][key].any()
    assert tc["cross"]["len"].dtype == torch.int32
    np.testing.assert_array_equal(_np(tc["cross"]["len"]), _np(jc["cross"]["len"]))


def test_decode_steps_match_reference_at_ragged_enc_lens(carried, j_decode):
    jcfg, tcfg = _cfgs()
    jp, tp, tokens, frames = carried
    jl_ = _decode(j_decode, jp, _j_cache(jp, frames, RAGGED), tokens, jax_side=True)
    step = make_decode_step(tcfg, B, S, device="cpu")
    tl_ = _decode(step, tp, _t_cache(tp, frames, RAGGED), tokens, jax_side=False)
    np.testing.assert_allclose(tl_, jl_, **LOGIT_TOL)


def test_teacher_forcing_holds_only_at_full_enc_lens(carried, j_decode):
    """Prefill then decode against ``forward_train``'s logits at each
    position: within 1e-4 at enc_lens == Se; at enc_lens < Se both packages
    part from it (decode masks the padding frames, teacher forcing does not)."""
    jcfg, tcfg = _cfgs()
    jp, tp, tokens, frames = carried
    tb = {"tokens": torch.from_numpy(tokens), "frames": torch.from_numpy(frames)}
    with torch.no_grad():
        t_tf = _np(tm.forward_train(tp, tb, tcfg)[0])[:, :STEPS]
    j_tf = _np(jm.forward_train(jp, {"tokens": jnp.asarray(tokens),
                                     "frames": jnp.asarray(frames)}, jcfg)[0])[:, :STEPS]
    step = make_decode_step(tcfg, B, S, device="cpu")
    full = np.full((B,), SE, np.int32)
    assert _row_rel(_decode(step, tp, _t_cache(tp, frames, full), tokens, jax_side=False),
                    t_tf) <= TF_TOL
    t_miss = _row_rel(_decode(step, tp, _t_cache(tp, frames, RAGGED), tokens, jax_side=False),
                      t_tf)
    j_miss = _row_rel(_decode(j_decode, jp, _j_cache(jp, frames, RAGGED), tokens,
                              jax_side=True), j_tf)
    assert t_miss > 100 * TF_TOL and j_miss > 100 * TF_TOL, (t_miss, j_miss)


def test_plain_kernels_at_d64_match_oracles():
    """The plain versions at heads of 64, the kernels' new D: flash
    non-causal with Sq != Skv (cross-attention in teacher forcing), decode
    at g = 1 with ragged lengths (cross-attention decode)."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 5, 4, 64), (2, 19, 4, 64), (2, 19, 4, 64)))
    out = flash_attention_plain(*map(torch.from_numpy, (q, k, v)), causal=False)
    np.testing.assert_allclose(_np(out), _np(j_flash_ref(q, k, v, causal=False)), **LAYER_TOL)
    qd = rng.standard_normal((3, 4, 64)).astype(np.float32)
    kd, vd = (rng.standard_normal((3, 40, 4, 64)).astype(np.float32) for _ in range(2))
    lens = np.array([40, 17, 1], np.int32)
    out = decode_attention_plain(*map(torch.from_numpy, (qd, kd, vd, lens)))
    np.testing.assert_allclose(_np(out), _np(j_decode_ref(qd, kd, vd, lens)), **LAYER_TOL)
