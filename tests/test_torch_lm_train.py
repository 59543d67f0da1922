"""The port's LM training path against the reference on the llama3-8b
smoke config in float32, with the reference's weights and optimizer state
carried across: ``loss_fn``'s loss, metrics and every gradient against
``jax.value_and_grad(loss_fn)`` (S = 640, so the CE runs in chunks of 512
and 128, with masked labels), and three ``train_step``s against the
reference's ``value_and_grad`` + ``adamw_update``.  Two JAX compiles.

Tolerances (f32, two layers, sums in another order): loss and metrics
rtol 1e-5; gradients rtol 1e-4, atol 1e-6; parameters, master weights and
moments after three AdamW steps rtol 1e-4, atol 1e-6."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.data import DataPipeline
from repro.models import model as jm
from repro.optim import OptConfig as JOpt, adamw_update as j_update, init_opt_state as j_init
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.convert import model_params_from_jax, opt_state_from_jax
from repro_torch.models import model as tm
from repro_torch.optim import OptConfig as TOpt, tree_leaves
from repro_torch.runtime.lm_train import make_train_tenant, train_step

GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
KW = dict(lr=1e-3, warmup_steps=5, decay_steps=1000)   # examples/co_schedule.py's tenant


def _cfgs(**kw):
    return (j_smoke("llama3-8b").replace(dtype="float32", **kw),
            t_smoke("llama3-8b").replace(dtype="float32", **kw))


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _port_params(np_params, cfg):
    params = model_params_from_jax(np_params, cfg, "cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return params


def _batch(cfg, B, S, seed, masked=()):
    b = DataPipeline(cfg.vocab_size, S, B, seed=seed, mode="uniform").batch(0)
    for row, lo, hi in masked:
        b["labels"][row, lo:hi] = -1
    return b


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _cfgs()
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, jax.device_get(jp)


def _port_loss_and_grads(params, batch, cfg):
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    total, metrics = tm.loss_fn(params, tb, cfg)
    grads = torch.autograd.grad(total, tree_leaves(params))
    return total, metrics, grads


def test_loss_and_grads_match_reference(setup):
    """S = 640: CE chunks of 512 and 128; labels masked across the chunk
    boundary in row 0 and at the end of row 1."""
    jcfg, tcfg, jp, np_params = setup
    batch = _batch(jcfg, 2, 640, seed=1, masked=((0, 500, 530), (1, 600, 640)))
    (jtotal, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss_fn(p, b, jcfg), has_aux=True))(jp, batch)
    total, metrics, grads = _port_loss_and_grads(_port_params(np_params, tcfg), batch, tcfg)
    assert sorted(metrics) == sorted(jmetrics)
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-5)
    for k in jmetrics:
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert metrics["tokens"].item() == 2 * 640 - 30 - 40
    jg = dict(_leaves(jax.device_get(jgrads)))
    names = [n for n, _ in _leaves(np_params)]
    assert len(names) == len(grads) == len(jg)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), jg[name], **GRAD_TOL, err_msg=name)


def test_block_remat_matches_no_remat(setup):
    """Checkpointing each layer changes what is stored, not the result."""
    _, tcfg, _, np_params = setup
    batch = _batch(tcfg, 2, 96, seed=2, masked=((1, 0, 10),))
    out = {}
    for remat in ("block", "none"):
        cfg = tcfg.replace(remat=remat)
        out[remat] = _port_loss_and_grads(_port_params(np_params, cfg), batch, cfg)
    assert out["block"][0].item() == pytest.approx(out["none"][0].item(), rel=1e-6)
    for a, b in zip(out["block"][2], out["none"][2]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_forward_train_logits_give_the_loss(setup):
    """``forward_train``'s full (B, S, V) f32 logits give ``loss_fn``'s
    loss and z-loss, computed without chunks."""
    _, tcfg, _, np_params = setup
    batch = _batch(tcfg, 2, 40, seed=4, masked=((0, 3, 9),))
    params = _port_params(np_params, tcfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        logits, aux = tm.forward_train(params, tb, tcfg)
        _, metrics = tm.loss_fn(params, tb, tcfg)
    assert logits.shape == (2, 40, tcfg.vocab_size) and logits.dtype == torch.float32
    assert sorted(aux) == ["moe_aux", "moe_drop_frac", "moe_z"]
    mask = tb["labels"] >= 0
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, tb["labels"].clamp_min(0).long()[..., None])[..., 0]
    n = mask.sum()
    assert metrics["loss"].item() == pytest.approx(((lse - gold)[mask].sum() / n).item(),
                                                   rel=1e-6)
    assert metrics["z_loss"].item() == pytest.approx((1e-4 * lse[mask].square().sum() / n).item(),
                                                     rel=1e-5)


def test_three_train_steps_match_reference(setup):
    jcfg, tcfg, jp, np_params = setup
    batch = _batch(jcfg, 2, 64, seed=3, masked=((0, 0, 5),))
    jopt, topt_cfg = JOpt(**KW), TOpt(**KW)

    @jax.jit
    def j_step(params, opt, batch):
        (_, m), grads = jax.value_and_grad(jm.loss_fn, has_aux=True)(params, batch, jcfg)
        params, opt, om = j_update(params, grads, opt, jopt)
        return params, opt, {**m, **om}

    js = j_init(jp)
    params = _port_params(np_params, tcfg)
    opt = opt_state_from_jax(jax.device_get(js), tcfg, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for step in range(3):
        jp, js, jmet = j_step(jp, js, batch)
        params, opt, met = train_step(params, opt, tb, tcfg, topt_cfg)
        for k in ("loss", "z_loss", "tokens", "grad_norm", "lr"):
            np.testing.assert_allclose(met[k].item(), float(jmet[k]), rtol=1e-5, err_msg=k)
        assert opt["count"].item() == int(js["count"]) == step + 1
        for key, port, ref in (("params", params, jp), ("master", opt["master"], js["master"]),
                               ("m", opt["m"], js["m"]), ("v", opt["v"], js["v"])):
            ref = dict(_leaves(jax.device_get(ref)))
            for name, t in _leaves(port):
                np.testing.assert_allclose(t.detach().numpy(), ref[name], **GRAD_TOL,
                                           err_msg=f"step {step + 1} {key}/{name}")


def test_train_tenant_learns_and_refuses_other_families():
    """The tenant's state carries each step's metrics; on its fixed markov
    batch the loss falls.  A family that is not ported (audio) is refused."""
    _, tcfg = _cfgs()
    t = make_train_tenant("llama-train", tcfg, 0.75, seq=32, batch=4, seed=5, device="cpu")
    state = t.state
    for _ in range(8):
        state = t.step_fn(state)
    losses = [m["loss"].item() for m in state[2]]
    assert len(losses) == 8 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert state[1]["count"].item() == 8
    with pytest.raises(NotImplementedError):
        tm.loss_fn({}, {"tokens": torch.zeros((1, 4), dtype=torch.long)},
                   t_smoke("seamless-m4t-large-v2"))
