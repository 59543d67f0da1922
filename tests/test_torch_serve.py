"""The port's serve path: the one-device step factories of
``runtime/steps.py`` and the ``launch/serve.py`` launcher, on the CPU, for
the moe, hybrid, vlm and audio families' smoke configs in float32; and the
parameter trees of the first three against the reference's."""
import re

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import model as jm
from repro_torch.configs import SHAPES, get_smoke_config as t_smoke, scaled_shape
from repro_torch.launch import serve
from repro_torch.models import encdec, model as tm
from repro_torch.models.layers import rmsnorm
from repro_torch.runtime.steps import make_decode_step, make_prefill_step

FAMILIES = {"moe": "qwen2-moe-a2.7b", "hybrid": "jamba-v0.1-52b", "vlm": "chameleon-34b"}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("arch", sorted(FAMILIES.values()) + ["deepseek-moe-16b"])
def test_init_params_shapes_match_param_shapes_and_reference(arch):
    """Leaf by leaf: the port's ``init_params`` against its
    ``param_shapes`` and against the reference's tree (shapes and dtypes,
    bf16 config, traced without drawing)."""
    cfg = t_smoke(arch)
    got = {k: (tuple(v.shape), str(v.dtype).split(".")[1])
           for k, v in _leaves(tm.init_params(cfg, seed=0, device="cpu"))}
    assert {k: s for k, (s, _) in got.items()} == dict(_leaves(tm.param_shapes(cfg)))
    ref = jax.eval_shape(lambda k: jm.init_params(j_smoke(arch), k), jax.random.PRNGKey(0))
    assert got == {k: (tuple(v.shape), str(v.dtype)) for k, v in _leaves(ref)}
    assert sum(math_prod(s) for s, _ in got.values()) == tm.count_params_analytic(cfg)


def math_prod(shape):
    return int(np.prod(shape, dtype=np.int64))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_step_factories_give_what_the_model_gives(family):
    cfg = t_smoke(FAMILIES[family]).replace(dtype="float32")
    params = tm.init_params(cfg, seed=1, device="cpu")
    shape = scaled_shape(SHAPES["prefill_32k"], 16, 2048)          # 2 x 16 tokens
    B, S = shape.global_batch, shape.seq_len
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S)))
    logits, cache = make_prefill_step(cfg, shape, device="cpu")(params, tokens)
    ref_logits, ref_cache = tm.prefill(params, tokens, cfg, S)
    torch.testing.assert_close(logits, ref_logits, atol=0, rtol=0)
    for (k, a), (_, b) in zip(_leaves(cache), _leaves(ref_cache)):
        torch.testing.assert_close(a, b, atol=0, rtol=0, msg=k)

    step = make_decode_step(cfg, B, S + 4, device="cpu")
    with pytest.raises(ValueError):
        make_prefill_step(cfg, shape, device="cpu")(params, tokens[:, :-1])
    c1, c2 = step.init_cache(params), tm.init_cache(params, cfg, B, S + 4)
    for t in range(4):
        pos = torch.full((B,), t, dtype=torch.int32)
        l1, c1 = step(params, c1, tokens[:, t], pos)
        l2, c2 = tm.decode_step(params, c2, tokens[:, t], pos, cfg)
        torch.testing.assert_close(l1, l2, atol=0, rtol=0)
    with pytest.raises(ValueError):
        step(params, c1, tokens[:1, 0], pos[:1])


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "jamba-v0.1-52b", "seamless-m4t-large-v2"])
def test_serve_main_runs_on_the_cpu(arch, capsys):
    logits = serve.main(["--arch", arch, "--scale", "smoke", "--batch", "3", "--gen", "5",
                         "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(r"decoded 5 steps x 3 seqs: [0-9.]+ tok/s \([0-9.]+ ms/step\)", line), line
    assert logits.shape == (3, t_smoke(arch).vocab_size) and torch.isfinite(logits).all()


def test_encdec_and_audio_are_refused():
    """The audio family's step factories on the CPU: the prefill step is the
    encoder pass (frames and enc_lens in, the cache out: what
    ``init_encdec_cache`` gives for the normed encoder output), the decode
    step gives what ``decode_step`` gives.  What they refuse: a token
    prefill (as the reference's ``prefill`` does), frames of another batch
    or width."""
    cfg = t_smoke("seamless-m4t-large-v2").replace(dtype="float32")
    params = tm.init_params(cfg, seed=1, device="cpu")
    shape = scaled_shape(SHAPES["decode_32k"], 64, 4096)            # 2 x 8 self slots
    B, S, Se = shape.global_batch, shape.seq_len, cfg.enc_len
    rng = np.random.default_rng(2)
    frames = torch.from_numpy(rng.standard_normal((B, Se, cfg.d_model)).astype(np.float32))
    enc_lens = torch.tensor([Se, 5], dtype=torch.int32)
    prefill = make_prefill_step(cfg, shape, device="cpu")
    cache = prefill(params, frames, enc_lens)
    with torch.no_grad():
        enc = encdec.encoder_apply(params["enc_layers"], frames, cfg,
                                   torch.arange(Se)[None, :])
        ref = encdec.init_encdec_cache(params, cfg, B, S, rmsnorm(enc, params["enc_norm"],
                                                                  cfg.norm_eps), enc_lens)
    for (k, a), (_, b) in zip(_leaves(cache), _leaves(ref)):
        torch.testing.assert_close(a, b, atol=0, rtol=0, msg=k)
    assert cache["self"]["k"].shape == (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.d_head)

    step = make_decode_step(cfg, B, S, device="cpu")
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 4)))
    c2 = {"self": {k: v.clone() for k, v in cache["self"].items()}, "cross": cache["cross"]}
    for t in range(4):
        pos = torch.full((B,), t, dtype=torch.int32)
        l1, cache = step(params, cache, tokens[:, t], pos)
        l2, c2 = tm.decode_step(params, c2, tokens[:, t], pos, cfg)
        torch.testing.assert_close(l1, l2, atol=0, rtol=0)
        assert torch.isfinite(l1).all()
    with pytest.raises(NotImplementedError):
        tm.prefill(params, tokens, cfg, 4)
    with pytest.raises(ValueError):
        prefill(params, frames[:1], enc_lens[:1])
    with pytest.raises(ValueError):
        prefill(params, frames[..., :-1], enc_lens)
