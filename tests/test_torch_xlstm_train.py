"""The port's xLSTM training path against the reference on the xlstm-125m
smoke config in float32 (d_model 64, 4 heads, two (mLSTM, sLSTM) pairs,
chunk 16), with the reference's weights and optimizer state carried
across: ``loss_fn``'s loss, metrics and every gradient against
``jax.value_and_grad(loss_fn)``, and three ``train_step``s against the
reference's ``value_and_grad`` + ``adamw_update``.  Two JAX compiles.

S = 600: the CE runs in chunks of 512 and 88 and the mLSTM pads its last
chunk of 16 (600 = 37 x 16 + 8); labels are masked across a CE chunk
boundary.  Tolerances (f32, sums in another order): loss and metrics rtol
1e-5; gradients rtol 1e-4, atol 1e-6; the moments after each of three
AdamW steps rtol 1e-4, atol 1e-6; the parameters and master weights rtol
1e-4, atol 1e-5.  Why 1e-5: an AdamW step moves an entry by up to lr (4e-4
at the second step) whatever its gradient's size, and the sLSTM gate
biases have gradients of about 1e-6 that are small differences of large
terms (h = o c / n barely moves with the input gate), which the two
packages agree on only to about 1e-8; such an entry moves by a few 1e-6
more in one package than in the other."""
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
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
KW = dict(lr=1e-3, warmup_steps=5, decay_steps=1000)   # examples/co_schedule.py's tenant


def _cfgs(**kw):
    return (j_smoke("xlstm-125m").replace(dtype="float32", n_layers=4, **kw),
            t_smoke("xlstm-125m").replace(dtype="float32", n_layers=4, **kw))


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
    jcfg, tcfg, jp, np_params = setup
    batch = _batch(jcfg, 2, 600, seed=1, masked=((0, 500, 530), (1, 590, 600)))
    (jtotal, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss_fn(p, b, jcfg), has_aux=True))(jp, batch)
    total, metrics, grads = _port_loss_and_grads(_port_params(np_params, tcfg), batch, tcfg)
    assert sorted(metrics) == sorted(jmetrics)
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-5)
    for k in jmetrics:
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert metrics["tokens"].item() == 2 * 600 - 30 - 10
    jg = dict(_leaves(jax.device_get(jgrads)))
    names = [n for n, _ in _leaves(np_params)]
    assert len(names) == len(grads) == len(jg) == 3 + 11 + 7
    for name, g in zip(names, grads):
        assert np.abs(jg[name]).max() > 0, name
        np.testing.assert_allclose(g.numpy(), jg[name], **GRAD_TOL, err_msg=name)


def test_pair_remat_matches_no_remat(setup):
    """Checkpointing each pair changes what is stored, not the result."""
    _, tcfg, _, np_params = setup
    batch = _batch(tcfg, 2, 40, seed=2, masked=((1, 0, 10),))
    out = {}
    for remat in ("block", "none"):
        cfg = tcfg.replace(remat=remat)
        out[remat] = _port_loss_and_grads(_port_params(np_params, cfg), batch, cfg)
    assert out["block"][0].item() == pytest.approx(out["none"][0].item(), rel=1e-6)
    for a, b in zip(out["block"][2], out["none"][2]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_three_train_steps_match_reference(setup):
    jcfg, tcfg, jp, np_params = setup
    batch = _batch(jcfg, 2, 40, seed=3, masked=((0, 0, 5),))
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
            tol = PARAM_TOL if key in ("params", "master") else GRAD_TOL
            for name, t in _leaves(port):
                np.testing.assert_allclose(t.detach().numpy(), ref[name], **tol,
                                           err_msg=f"step {step + 1} {key}/{name}")


def test_xlstm_train_tenant_learns():
    """``make_train_tenant`` on the bf16 smoke config, as step 4's
    ``xlstm-train`` tenant (32 x 4 markov tokens): its loss falls over
    eight steps and every loss is finite."""
    cfg = t_smoke("xlstm-125m")
    t = make_train_tenant("xlstm-train", cfg, 0.25, seq=32, batch=4, seed=9, device="cpu")
    state = t.state
    for _ in range(8):
        state = t.step_fn(state)
    losses = [m["loss"].item() for m in state[2]]
    assert len(losses) == 8 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert state[1]["count"].item() == 8
    assert state[0]["pairs"]["slstm"]["slstm_r"].dtype == torch.float32
