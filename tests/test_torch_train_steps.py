"""The train half of the port's ``runtime/steps.py`` on the CPU: the
abstract state and batch against the reference's (``jax.eval_shape`` of
its init and optimizer state, its ``batch_specs``: shapes and dtypes, leaf
by leaf) for every family; ``make_train_step``'s checks; and the train
tenant of ``runtime/lm_train.py`` (which steps through
``make_train_step``) for every family whose batch the data pipeline makes."""
import jax
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.runtime import steps as jsteps
from repro_torch.configs import SHAPES, get_smoke_config as t_smoke, scaled_shape
from repro_torch.models import model as tm
from repro_torch.optim import OptConfig, init_opt_state
from repro_torch.runtime.lm_train import make_train_tenant
from repro_torch.runtime.steps import abstract_state, batch_specs, make_train_step

ARCHS = {"dense": "llama3-8b", "moe": "qwen2-moe-a2.7b", "hybrid": "jamba-v0.1-52b",
         "vlm": "chameleon-34b", "ssm": "xlstm-125m", "audio": "seamless-m4t-large-v2"}


def _paths(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _paths(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _leaves(tree):
    """Each leaf's (shape, dtype name) by path."""
    return {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in _paths(tree)}


@pytest.mark.parametrize("family", sorted(ARCHS))
def test_abstract_state_matches_reference(family):
    arch = ARCHS[family]
    params, opt = abstract_state(t_smoke(arch))
    assert all(t.device.type == "meta" for t in jax.tree.leaves(params))
    jparams, jopt = jsteps.abstract_state(j_smoke(arch))
    assert _leaves(params) == _leaves(jparams)
    assert _leaves(opt) == _leaves(jopt)
    shapes = {k: s for k, (s, _) in _leaves(params).items()}
    assert shapes == dict(_paths(tm.param_shapes(t_smoke(arch))))
    assert abstract_state(t_smoke(arch), with_opt=False)[1] is None


@pytest.mark.parametrize("family, S", [("dense", 64), ("audio", 8), ("audio", 64)])
def test_batch_specs_match_reference(family, S):
    """The audio batch's frames: (B, min(enc_len, S), M) (enc_len 16)."""
    arch = ARCHS[family]
    shape = scaled_shape(SHAPES["train_4k"], 64, 4096 // S)                    # 4 x S
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    ref, _ = jsteps.batch_specs(j_smoke(arch), shape, mesh)
    got = batch_specs(t_smoke(arch), shape)
    assert _leaves(got) == _leaves(ref)
    assert all(t.device.type == "meta" for t in got.values())


def test_make_train_step_checks_its_batch():
    cfg = t_smoke("seamless-m4t-large-v2").replace(dtype="float32")
    step = make_train_step(cfg, OptConfig(), device="cpu")
    params = tm.init_params(cfg, seed=0, device="cpu")
    opt = init_opt_state(params)
    tokens = torch.zeros((2, 8), dtype=torch.int64)
    frames = torch.zeros((2, 8, cfg.d_model))
    with pytest.raises(ValueError):                     # labels of another length
        step(params, opt, {"tokens": tokens, "labels": tokens[:, :-1], "frames": frames})
    with pytest.raises(ValueError):                     # frames of another width
        step(params, opt, {"tokens": tokens, "labels": tokens, "frames": frames[..., :-1]})
    with pytest.raises(ValueError):                     # a 1-D token row
        step(params, opt, {"tokens": tokens[0], "labels": tokens[0], "frames": frames})
    with pytest.raises(ValueError):                     # a step for the card, CPU tensors
        make_train_step(cfg, OptConfig(), device="cuda")(
            params, opt, {"tokens": tokens, "labels": tokens, "frames": frames})
    params, opt, metrics = step(params, opt, {"tokens": tokens, "labels": tokens,
                                              "frames": frames})
    assert opt["count"].item() == 1 and torch.isfinite(metrics["loss"])
    assert sorted(metrics) == ["grad_norm", "loss", "lr", "moe_aux", "moe_drop_frac",
                               "tokens", "z_loss"]


@pytest.mark.parametrize("family", ["moe", "hybrid", "vlm", "ssm"])
def test_train_tenant_takes_the_family(family):
    t = make_train_tenant(f"{family}-train", t_smoke(ARCHS[family]), 0.5, seq=16, batch=2,
                          seed=3, device="cpu")
    state = t.step_fn(t.step_fn(t.state))
    assert state[1]["count"].item() == 2
    assert all(torch.isfinite(m["loss"]) for m in state[2])
