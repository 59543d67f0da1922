"""Shared checks of the port's training path against the reference's, for
the ``tests/test_torch_*_train.py`` files: the same f32 smoke config in
both packages, the reference's weights (``jax.random.PRNGKey(0)``) carried
across by ``model_params_from_jax``, the same numpy batch.

- :func:`check_loss_and_grads`: ``loss_fn``'s total, metrics and every
  gradient against ``jax.value_and_grad(loss_fn)`` (one JAX compile).
- :func:`check_three_steps`: three steps of ``make_train_step`` against the
  reference's jitted ``value_and_grad`` + ``adamw_update`` (one JAX
  compile): the metrics, then params, master weights, m and v after each.

Tolerances, those of ``tests/test_torch_lm_train.py`` (f32, sums in
another order): total and metrics rtol 1e-5 (``moe_drop_frac`` and
``tokens`` equal); gradients, and m and v after each of three AdamW steps,
rtol 1e-4, atol 1e-6.  One bound is looser, :data:`STEP_TOL` for the
parameters and master weights after a step: rtol 1e-4, atol 5e-5, a
quarter of the first step's learning rate (2e-4).  AdamW divides each
gradient entry by its own magnitude (``m / (sqrt(v) + eps)``, eps 1e-8),
so an entry whose gradient is within an order of eps moves by a fraction
of the learning rate set by the gradient's last digits, where the gradient
itself (and so m and v) still agrees within the default bound.  Measured
(three steps, the worst entry of any leaf): jamba 2.05e-5 in the first
step and no more after it, chameleon 1.36e-5, seamless 2.31e-6,
deepseek-moe 1.77e-6, llama3-8b (``test_torch_lm_train.py``) 2.5e-7."""
import dataclasses

import jax
import numpy as np
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import model as jm
from repro.optim import OptConfig as JOpt, adamw_update as j_update, init_opt_state as j_init
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.convert import model_params_from_jax, opt_state_from_jax
from repro_torch.models import model as tm
from repro_torch.optim import OptConfig as TOpt, tree_leaves
from repro_torch.runtime.steps import make_train_step

LOSS_TOL = dict(rtol=1e-5, atol=1e-7)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
STEP_TOL = dict(rtol=1e-4, atol=5e-5)
KW = dict(lr=1e-3, warmup_steps=5, decay_steps=1000)   # examples/co_schedule.py's tenant


def cfgs(arch: str, capacity_factor: float | None = None, **kw):
    """``arch``'s smoke config in f32 in both packages, with ``kw`` replaced."""
    out = []
    for smoke in (j_smoke, t_smoke):
        cfg = smoke(arch).replace(dtype="float32", **kw)
        if capacity_factor is not None:
            cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=capacity_factor))
        out.append(cfg)
    return tuple(out)


def leaves(tree, prefix=""):
    """``(path, leaf)`` in the reference's tree order (sorted keys)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def make_batch(cfg, B: int, S: int, seed: int, Se: int | None = None) -> dict:
    """Uniform tokens and labels from ``np.random.default_rng(seed)``, labels
    3..6 of row 0 masked; with ``Se``, standard normal frames (B, Se, M)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    batch["labels"][0, 3:7] = -1
    if Se is not None:
        batch["frames"] = rng.standard_normal((B, Se, cfg.d_model)).astype(np.float32)
    return batch


def reference_params(jcfg):
    return jm.init_params(jcfg, jax.random.PRNGKey(0))


def port_params(jp, tcfg):
    params = model_params_from_jax(jax.device_get(jp), tcfg, "cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return params


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _check_metrics(got: dict, ref: dict, what: str) -> None:
    for k in ref:
        if k in ("moe_drop_frac", "tokens"):
            assert got[k].item() == float(ref[k]), (what, k, got[k].item(), float(ref[k]))
        else:
            np.testing.assert_allclose(got[k].item(), float(ref[k]), **LOSS_TOL,
                                       err_msg=f"{what} {k}")


def port_loss_and_grads(params, batch, tcfg):
    total, metrics = tm.loss_fn(params, _torch_batch(batch), tcfg)
    return total, metrics, torch.autograd.grad(total, tree_leaves(params))


def check_loss_and_grads(jcfg, tcfg, batch) -> dict:
    """Returns the port's metrics."""
    jp = reference_params(jcfg)
    (jtotal, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss_fn(p, b, jcfg), has_aux=True))(jp, batch)
    total, metrics, grads = port_loss_and_grads(port_params(jp, tcfg), batch, tcfg)
    assert sorted(metrics) == sorted(jmetrics)
    np.testing.assert_allclose(total.item(), float(jtotal), **LOSS_TOL)
    _check_metrics(metrics, jmetrics, "loss_fn")
    jg = list(leaves(jax.device_get(jgrads)))
    assert len(jg) == len(grads)
    for (name, ref), g in zip(jg, grads):
        np.testing.assert_allclose(g.numpy(), ref, **GRAD_TOL, err_msg=name)
    return metrics


def check_three_steps(jcfg, tcfg, batch) -> list[dict]:
    """Returns the port's metrics of each step."""
    jopt = JOpt(**KW)

    @jax.jit
    def j_step(params, opt, batch):
        (_, m), grads = jax.value_and_grad(jm.loss_fn, has_aux=True)(params, batch, jcfg)
        params, opt, om = j_update(params, grads, opt, jopt)
        return params, opt, {**m, **om}

    jp = reference_params(jcfg)
    js = j_init(jp)
    params = port_params(jp, tcfg)
    opt = opt_state_from_jax(jax.device_get(js), tcfg, "cpu")
    step = make_train_step(tcfg, TOpt(**KW), device="cpu")
    tb = _torch_batch(batch)
    out = []
    for i in range(3):
        jp, js, jmet = j_step(jp, js, batch)
        params, opt, met = step(params, opt, tb)
        _check_metrics(met, jmet, f"step {i + 1}")
        assert opt["count"].item() == int(js["count"]) == i + 1
        for key, port, ref in (("params", params, jp), ("master", opt["master"], js["master"]),
                               ("m", opt["m"], js["m"]), ("v", opt["v"], js["v"])):
            ref = dict(leaves(jax.device_get(ref)))
            tol = STEP_TOL if key in ("params", "master") else GRAD_TOL
            for name, t in leaves(port):
                np.testing.assert_allclose(t.detach().numpy(), ref[name], **tol,
                                           err_msg=f"step {i + 1} {key}/{name}")
        out.append(met)
    return out
