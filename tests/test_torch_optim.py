"""The port's AdamW (``repro_torch/optim``) against the reference's
(``repro/optim/adamw.py``) on the same numpy inputs: the schedule, the
global norm, and three updates (one of them clipped) of a tree with stacked
(L, M) norm scales, carried grads and carried state.  f32 throughout;
tolerance rtol 1e-5, atol 1e-7 (the same formulas in another rounding
order: the port's fused pass divides by the inverse clip scale, decays
before the Adam step and forms the bias corrections in double)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import OptConfig as JOpt, adamw_update as j_update, global_norm as j_norm
from repro.optim import init_opt_state as j_init, lr_at as j_lr
from repro_torch.optim import OptConfig as TOpt, adamw_update as t_update, global_norm as t_norm
from repro_torch.optim import init_opt_state as t_init, lr_at as t_lr, tree_leaves, tree_map

TOL = dict(rtol=1e-5, atol=1e-7)
KW = dict(lr=1e-3, warmup_steps=5, decay_steps=40, weight_decay=0.1, clip_norm=1.0)


def _tree(rng, scale=1.0):
    L, M, F = 3, 8, 12
    return {"emb": rng.standard_normal((20, M)) * scale,
            "final_norm": rng.standard_normal((M,)) * scale,
            "layers": {"ln1": rng.standard_normal((L, M)) * scale,
                       "mlp": {"wg": rng.standard_normal((L, M, F)) * scale}}}


def _np(tree):
    return tree_map(lambda a: np.asarray(a, np.float32), tree)


def _torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.asarray(a, np.float32).copy()), tree)


def _close(t_tree, j_tree):
    for a, b in zip(tree_leaves(t_tree), jax.tree.leaves(j_tree)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_lr_schedule_matches_reference():
    cfg_j, cfg_t = JOpt(**KW), TOpt(**KW)
    for step in (0, 1, 3, 4, 5, 6, 20, 39, 40, 41, 1000):
        np.testing.assert_allclose(t_lr(cfg_t, torch.tensor(step, dtype=torch.int32)).item(),
                                   float(j_lr(cfg_j, jnp.int32(step))), rtol=1e-6, atol=0)
    assert t_lr(cfg_t, 1).item() == pytest.approx(2e-4, rel=1e-6)          # warm-up
    assert t_lr(cfg_t, 1000).item() == pytest.approx(1e-4, rel=1e-6)       # floor


def test_global_norm_matches_reference():
    tree = _np(_tree(np.random.default_rng(0)))
    np.testing.assert_allclose(t_norm(_torch(tree)).item(),
                               float(j_norm(jax.tree.map(jnp.asarray, tree))), rtol=1e-6)


def test_three_updates_match_reference():
    """Steps 1 and 3 are not clipped (grad norm < 1); step 2 is (norm ~ 30).
    Step 3's stacked ln1 and 1-D final_norm get zero grads: ln1 (L, M) still
    decays in both packages, final_norm stays as it is."""
    rng = np.random.default_rng(1)
    params = _np(_tree(rng))
    grads = [_np(_tree(rng, 0.02)), _np(_tree(rng, 3.0)), _np(_tree(rng, 0.02))]
    grads[2]["layers"]["ln1"][:] = 0.0
    grads[2]["final_norm"][:] = 0.0
    cfg_j, cfg_t = JOpt(**KW), TOpt(**KW)
    jp = jax.tree.map(jnp.asarray, params)
    js = j_init(jp)
    tp = _torch(params)
    ts = t_init(tp)
    step = jax.jit(lambda p, g, s: j_update(p, g, s, cfg_j))
    for i, g in enumerate(grads):
        before = {k: v.clone() for k, v in (("ln1", ts["master"]["layers"]["ln1"]),
                                            ("final_norm", ts["master"]["final_norm"]))}
        jp, js, jm = step(jp, jax.tree.map(jnp.asarray, g), js)
        tp, ts, tm = t_update(tp, _torch(g), ts, cfg_t)
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(tm["lr"].item(), float(jm["lr"]), rtol=1e-6)
        assert ts["count"].item() == int(js["count"]) == i + 1
        assert ts["count"].dtype == torch.int32
        for key in ("master", "m", "v"):
            _close(ts[key], js[key])
        _close(tp, jp)
        if i == 1:
            assert tm["grad_norm"].item() > 10 * KW["clip_norm"]                # clipped
        if i == 2:
            ln1 = ts["master"]["layers"]["ln1"]
            expect = before["ln1"] - tm["lr"] * (KW["weight_decay"] * before["ln1"]
                                                 + ts["m"]["layers"]["ln1"] / (1 - 0.9 ** 3)
                                                 / (torch.sqrt(ts["v"]["layers"]["ln1"]
                                                               / (1 - 0.95 ** 3)) + 1e-8))
            torch.testing.assert_close(ln1, expect, **TOL)
            assert not torch.equal(ln1, before["ln1"])
            no_decay = before["final_norm"] - tm["lr"] * (
                ts["m"]["final_norm"] / (1 - 0.9 ** 3)
                / (torch.sqrt(ts["v"]["final_norm"] / (1 - 0.95 ** 3)) + 1e-8))
            torch.testing.assert_close(ts["master"]["final_norm"], no_decay, **TOL)


def test_update_keeps_dtypes_and_works_in_place():
    """A bf16 leaf stays bf16 (rounded from its f32 master); the update
    writes into the given params and moments."""
    params = {"w": torch.randn(4, 4).to(torch.bfloat16), "b": torch.zeros(4)}
    state = t_init(params)
    w_id, m_id = params["w"].data_ptr(), state["m"]["w"].data_ptr()
    grads = {"w": torch.ones(4, 4, dtype=torch.bfloat16), "b": torch.ones(4)}
    out, state, _ = t_update(params, grads, state, TOpt(**KW))
    assert out["w"].dtype == torch.bfloat16 and out["w"].data_ptr() == w_id
    assert state["m"]["w"].data_ptr() == m_id
    assert torch.equal(out["w"], state["master"]["w"].to(torch.bfloat16))
    assert torch.equal(grads["w"], torch.ones(4, 4, dtype=torch.bfloat16))    # grads untouched
