"""The port's MoE block and the moe family against the reference, on the
deepseek-moe-16b smoke config (d_model 64, 8 routed experts top-2, 2
shared) in float32, with the reference's weights carried across by
``model_params_from_jax``.

Discrete outputs (expert ids, the kept mask, ``moe_drop_frac``) must be
equal; module outputs within 1e-4 of the reference's norm; logits within
atol 2e-3, rtol 2e-2 (tests/test_models.py:88-89)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import model as jm, moe as jmoe
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.convert import model_params_from_jax
from repro_torch.models import model as tm, moe as tmoe
from repro_torch.models.mlp import swiglu_apply

ARCH = "deepseek-moe-16b"
NORM_TOL = 1e-4
LOGIT_TOL = dict(atol=2e-3, rtol=2e-2)


def _cfgs(cap=None):
    jcfg, tcfg = (f(ARCH).replace(dtype="float32") for f in (j_smoke, t_smoke))
    if cap is not None:
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, capacity_factor=cap))
        tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe, capacity_factor=cap))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def carried():
    jcfg, tcfg = _cfgs()
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0))
    return jp, model_params_from_jax(jax.device_get(jp), tcfg, "cpu")


def _layer0(jp, tp):
    return (jax.tree.map(lambda a: a[0], jp["layers"]["moe"]),
            {k: (v[0] if not isinstance(v, dict) else {n: w[0] for n, w in v.items()})
             for k, v in tp["layers"]["moe"].items()})


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close_in_norm(got, ref, tol=NORM_TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel <= tol, f"relative error {rel:.3e} above {tol:g}"


def _reference_keep(ids, E, cap):
    """The reference's kept mask and slots, by its own lines
    (repro/models/moe.py:74-85), on its ids."""
    T, K = ids.shape
    flat_ids = ids.reshape(-1)
    order = jnp.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[order]
    counts = jnp.bincount(flat_ids, length=E)
    starts = jnp.cumsum(counts) - counts
    pos_in_e = jnp.arange(T * K, dtype=jnp.int32) - starts[sorted_ids].astype(jnp.int32)
    keep = pos_in_e < cap
    return np.asarray(order), np.asarray(keep), np.asarray(jnp.where(keep, pos_in_e, cap))


@pytest.mark.parametrize("cap", [0.5, 16.0])    # tokens dropped; test_models.py:79's ample
def test_moe_apply_matches_reference(carried, cap):
    jcfg, tcfg = _cfgs(cap)
    pj, pt = _layer0(*carried)
    x = _x((2, 24, jcfg.d_model), 1)
    # jitted, as the reference's model runs it (eager, XLA rounds
    # 1 - mean(keep) twice; under jit once, and the port follows the jit)
    yj, auxj = jax.jit(lambda p, x: jmoe.moe_apply(p, x, jcfg))(pj, jnp.asarray(x))
    yt, auxt = tmoe.moe_apply(pt, torch.from_numpy(x), tcfg)
    _close_in_norm(yt.numpy(), yj)
    assert float(auxt["moe_drop_frac"]) == float(auxj["moe_drop_frac"])
    assert (float(auxt["moe_drop_frac"]) > 0.0) == (cap < 1.0)
    for key in ("moe_aux", "moe_z"):
        np.testing.assert_allclose(float(auxt[key]), float(auxj[key]), rtol=1e-5)

    # the routing and the dispatch plan: ids, order, slots and kept mask
    T, E = 48, jcfg.moe.n_routed
    logits = x.reshape(T, -1) @ np.asarray(pj["router"])
    _, _, ids_j = jmoe.router_topk(jnp.asarray(logits), jcfg.moe.top_k)
    _, _, ids_t = tmoe.router_topk(torch.from_numpy(logits), tcfg.moe.top_k)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    cap_slots = tmoe.capacity(tcfg, T)
    order_j, keep_j, dst_j = _reference_keep(ids_j, E, cap_slots)
    order_t, _, dst_t, keep_t = tmoe.dispatch(ids_t, E, cap_slots)
    np.testing.assert_array_equal(order_t.numpy(), order_j)
    np.testing.assert_array_equal(keep_t.numpy(), keep_j)
    np.testing.assert_array_equal(dst_t.numpy(), dst_j)
    assert float(auxt["moe_drop_frac"]) == np.float32(1.0 - keep_j.sum() * np.float64(
        np.float32(1.0 / keep_j.size)))


def test_router_topk_and_load_balance_loss():
    logits = _x((64, 8), 2) * 3.0
    pj, wj, ij = jmoe.router_topk(jnp.asarray(logits), 3)
    pt, wt, it = tmoe.router_topk(torch.from_numpy(logits), 3)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-7, rtol=1e-6)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-7, rtol=1e-6)
    np.testing.assert_allclose(float(tmoe.load_balance_loss(pt, it, 8)),
                               float(jmoe.load_balance_loss(pj, ij, 8)), rtol=1e-6)


def test_moe_decode_matches_reference(carried):
    """Grouped by expert, the same function as the reference's per-token
    gather; at batch 9 (18 pairs over 8 experts) experts serve several
    tokens and some serve none."""
    jcfg, tcfg = _cfgs()
    pj, pt = _layer0(*carried)
    x = _x((9, jcfg.d_model), 3)
    _close_in_norm(tmoe.moe_decode(pt, torch.from_numpy(x), tcfg).numpy(),
                   jmoe.moe_decode(pj, jnp.asarray(x), jcfg))


def test_model_prefill_then_decode_matches_reference(carried):
    """Prefill of 12 tokens (tokens dropped at capacity 1.25: both sides
    drop the same ones), then 6 decode steps at ragged positions."""
    jcfg, tcfg = _cfgs()
    jp, tp = carried
    B, S = 2, 12
    tokens = np.random.default_rng(4).integers(0, jcfg.vocab_size, (B, S + 6)).astype(np.int32)
    lj, cj = jm.prefill(jp, jnp.asarray(tokens[:, :S]), jcfg, S)
    lt, ct = tm.prefill(tp, torch.from_numpy(tokens[:, :S]), tcfg, S)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(ct[key].numpy(), np.asarray(cj[key]), **LOGIT_TOL)

    smax = S + 8
    grow = ((0, 0), (0, 0), (0, smax - S), (0, 0), (0, 0))
    cj = {k: jnp.pad(v, grow) for k, v in cj.items()}
    ct = {k: torch.from_numpy(np.pad(v.numpy(), grow)) for k, v in ct.items()}
    step = jax.jit(lambda p, c, t, q: jm.decode_step(p, c, t, q, jcfg))
    start = np.array([S, S - 5], np.int32)        # row 1 overwrites its last 5 slots
    for t in range(6):
        pos = start + t
        tok = tokens[:, S + t]
        lj, cj = step(jp, cj, jnp.asarray(tok), jnp.asarray(pos))
        lt, ct = tm.decode_step(tp, ct, torch.from_numpy(tok), torch.from_numpy(pos), tcfg)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL, err_msg=f"step {t}")
    np.testing.assert_allclose(ct["k"].numpy(), np.asarray(cj["k"]), **LOGIT_TOL)


def test_loss_fn_and_aux_metrics_match_reference(carried):
    jcfg, tcfg = _cfgs()
    jp, tp = carried
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 20)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    totj, mj = jm.loss_fn(jp, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}, jcfg)
    tott, mt = tm.loss_fn(tp, {"tokens": torch.from_numpy(tokens),
                               "labels": torch.from_numpy(labels)}, tcfg)
    np.testing.assert_allclose(float(tott), float(totj), rtol=1e-5)
    for key in ("loss", "z_loss", "moe_aux", "tokens"):
        np.testing.assert_allclose(float(mt[key]), float(mj[key]), rtol=1e-5, err_msg=key)
    assert float(mj["moe_drop_frac"]) > 0.0       # summed over the 2 layers, as the reference
    assert float(mt["moe_drop_frac"]) == float(mj["moe_drop_frac"])


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", ARCH])
def test_mesh_decode_route_matches_reference(arch):
    """The route the sharded decode step takes on each rank's shard
    (``moe._gathered``: each token's K expert matrices gathered, then
    products, the reference's own route) with the router and the shared
    experts, f32, the reference's weights, at batch 9, within 1e-5 of the
    reference's ``moe_decode``; and where a rank holds experts ``e0 ..``
    only, the ranks' parts sum to the whole (the ``Partial`` sum the mesh
    reduces)."""
    jcfg, tcfg = (f(arch).replace(dtype="float32") for f in (j_smoke, t_smoke))
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0))
    pj, pt = _layer0(jp, model_params_from_jax(jax.device_get(jp), tcfg, "cpu"))
    x = np.random.default_rng(0).normal(size=(9, jcfg.d_model)).astype(np.float32)
    xt = torch.from_numpy(x)
    _, w, ids = tmoe.router_topk(xt @ pt["router"], tcfg.moe.top_k)
    experts = [pt[k] for k in ("experts_wg", "experts_wu", "experts_wd")]
    whole = tmoe._gathered(xt, w, ids, *experts)
    got = whole + swiglu_apply(pt["shared"], xt)
    _close_in_norm(got.numpy(), jmoe.moe_decode(pj, jnp.asarray(x), jcfg), tol=1e-5)

    half = tcfg.moe.n_routed // 2
    parts = [tmoe._gathered(xt, w, ids, *(e[lo:lo + half] for e in experts), lo)
             for lo in (0, half)]
    torch.testing.assert_close(parts[0] + parts[1], whole, rtol=1e-6, atol=1e-6)
