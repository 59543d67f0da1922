"""Replay and the DQN agent's training half: the port against the JAX package
on the same numpy inputs and the same drawn numbers.

JAX's threefry draws cannot be reproduced in torch, so each test draws the
reference's numbers with ``jax.random`` (splitting the key as the reference
does) and hands them to the port's samplers.  Tolerances:

  * sum-trees: bit-equal (the same f32 additions in the same order);
  * sampled indices and batches: equal; IS weights within 1e-6 relative
    (``pow`` may round its last bit differently);
  * one double-DQN update: loss within 1e-5 relative, Adam moments within
    rtol 1e-4 / atol 1e-6 (autograd and XLA sum the same products in
    different orders), new params within rtol 1e-4 / atol 1e-5, which is 2%
    of one Adam step (lr = 5e-4): Adam moves an entry by about
    ``lr * m / sqrt(v)``, and for an entry whose gradient cancels to nearly
    0 that ratio depends on the last bits of the sum.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import agent as ja
from repro.core import replay as jr
from repro.core.network import init_dqn as jinit
from repro_torch.convert import dqn_agent_from_numpy, dqn_params_from_numpy
from repro_torch.core import agent as ta
from repro_torch.core import replay as tr

D, A = 12, 7


def _block(rng, n):
    mask2 = rng.random((n, A)) < 0.6
    mask2[:, 0] = True
    return {"s": rng.standard_normal((n, D)).astype(np.float32),
            "a": rng.integers(0, A, n).astype(np.int32),
            "r": rng.standard_normal(n).astype(np.float32) * 50,
            "s2": rng.standard_normal((n, D)).astype(np.float32),
            "done": (rng.random(n) < 0.2).astype(np.float32),
            "mask2": mask2}


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    out = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in b.items()}
    out["a"] = out["a"].long()
    return out


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _assert_batch_equal(jbatch, tbatch):
    for k in tr.FIELDS:
        np.testing.assert_array_equal(np.asarray(jbatch[k]), tbatch[k].numpy(), err_msg=k)


# ---------------------------------------------------------------------------
# uniform ring
# ---------------------------------------------------------------------------

def test_uniform_ring_push_wraps_and_samples_jax_indices():
    rng = np.random.default_rng(0)
    js, ts = jr.replay_init(16, D, A), tr.replay_init(16, D, A, device="cpu")
    key = jax.random.PRNGKey(3)
    for i in range(7):                                   # 28 transitions: wraps once
        b = _block(rng, 4)
        js, ts = jr.replay_push(js, _jb(b)), tr.replay_push(ts, _tb(b))
        assert (int(js.ptr), int(js.size)) == (ts.ptr, ts.size)
        key, k = jax.random.split(key)
        idx = jr._uniform_indices(js, k, 10)
        _assert_batch_equal(jr.replay_sample(js, k, 10),
                            tr.replay_sample(ts, 10, idx=torch.from_numpy(np.array(idx))))
    for f in tr.FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(js, f)), getattr(ts, f).numpy())


def test_uniform_ring_refuses_unaligned_push_and_empty_sample():
    ts = tr.replay_init(16, D, A, device="cpu")
    with pytest.raises(AssertionError, match="empty"):
        tr.replay_sample(ts, 4)
    ts = tr.replay_push(ts, _tb(_block(np.random.default_rng(1), 4)))
    with pytest.raises(AssertionError):
        tr.replay_push(ts, _tb(_block(np.random.default_rng(2), 8)))
    with pytest.raises(AssertionError, match="divide"):
        tr.replay_push(tr.replay_init(10, D, A, device="cpu"),
                       _tb(_block(np.random.default_rng(2), 4)))


def test_uniform_sample_draws_from_the_filled_region():
    ts = tr.replay_init(64, D, A, device="cpu")
    ts = tr.replay_push(ts, _tb(_block(np.random.default_rng(1), 8)))
    batch = tr.replay_sample(ts, 500, generator=torch.Generator().manual_seed(0))
    assert len({tuple(r) for r in batch["s"].numpy().round(5)}) == 8


# ---------------------------------------------------------------------------
# prioritized sum-tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity,block", [(24, 4), (64, 8)])
def test_sum_tree_bit_equal_and_samples_match(capacity, block):
    """Pushes, priority updates and stratified samples, step for step.

    The updates use alpha = 1, where ``p = |td| + eps`` is exact in both
    packages, so the trees stay bit-equal through them: f32 ``pow`` with
    another exponent may round its last bit differently (next test)."""
    rng = np.random.default_rng(capacity)
    alpha, beta, eps = 1.0, 0.5, 1e-3
    jp = jr.per_init(capacity, D, A)
    tp = tr.per_init(capacity, D, A, device="cpu")
    key = jax.random.PRNGKey(capacity)
    for i in range(2 * capacity // block):
        b = _block(rng, block)
        jp, tp = jr.per_push(jp, _jb(b)), tr.per_push(tp, _tb(b))
        assert np.array_equal(np.asarray(jp.tree), tp.tree.numpy()), "tree after push"
        key, k_s = jax.random.split(key)                  # the engine's split
        jbatch, jidx, jw = jr.per_sample(jp, k_s, 16, alpha, beta)
        u = jax.random.uniform(k_s, (16,))                # per_sample's own draw
        tbatch, tidx, tw = tr.per_sample(tp, 16, alpha, beta, u=torch.from_numpy(np.array(u)))
        np.testing.assert_array_equal(np.asarray(jidx), tidx.numpy())
        np.testing.assert_allclose(np.asarray(jw), tw.numpy(), rtol=1e-6)
        _assert_batch_equal(jbatch, tbatch)
        # a transition's TD error is one value, however often it was drawn
        td = (np.sin(np.asarray(jidx) * 1.7 + i) * 3).astype(np.float32)
        jp = jr.per_update(jp, jidx, jnp.asarray(td), alpha, eps)
        tp = tr.per_update(tp, tidx, torch.from_numpy(td), alpha, eps)
        assert np.array_equal(np.asarray(jp.tree), tp.tree.numpy()), "tree after update"
        assert float(jp.max_p) == float(tp.max_p)
    # the incremental tree equals a rebuild from its leaves
    assert torch.equal(tr._tree_rebuild(tp.tree), tp.tree)


def test_priority_update_with_fractional_alpha():
    """alpha = 0.6: leaf priorities within one f32 ulp of the reference's,
    and the tree bit-equal to a rebuild from its own leaves."""
    rng = np.random.default_rng(1)
    jp, tp = jr.per_init(40, D, A), tr.per_init(40, D, A, device="cpu")
    for _ in range(5):
        b = _block(rng, 8)
        jp, tp = jr.per_push(jp, _jb(b)), tr.per_push(tp, _tb(b))
    idx = rng.permutation(40)[:24]
    td = (rng.standard_normal(24) * 4).astype(np.float32)
    jp = jr.per_update(jp, jnp.asarray(idx), jnp.asarray(td), 0.6, 1e-3)
    tp = tr.per_update(tp, torch.from_numpy(idx), torch.from_numpy(td), 0.6, 1e-3)
    L = tp.tree.shape[0] // 2
    np.testing.assert_allclose(tp.tree[L:].numpy(), np.asarray(jp.tree)[L:], rtol=2.4e-7, atol=0)
    assert torch.equal(tr._tree_rebuild(tp.tree), tp.tree)
    np.testing.assert_allclose(float(tp.max_p), float(jp.max_p), rtol=2.4e-7)


def test_per_alpha_zero_is_the_uniform_draw_with_unit_weights():
    rng = np.random.default_rng(4)
    tp = tr.per_init(32, D, A, device="cpu")
    ts = tr.replay_init(32, D, A, device="cpu")
    for _ in range(3):
        b = _block(rng, 8)
        tp, ts = tr.per_push(tp, _tb(b)), tr.replay_push(ts, _tb(b))
    g1, g2 = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    pb, _, w = tr.per_sample(tp, 20, 0.0, 0.4, generator=g1)
    ub = tr.replay_sample(ts, 20, generator=g2)
    assert torch.equal(w, torch.ones(20))
    for f in tr.FIELDS:
        assert torch.equal(pb[f], ub[f])


def test_numpy_buffers_are_the_reference_copies():
    rng = np.random.default_rng(5)
    jb, tb = jr.PrioritizedReplayBuffer(20, D, A, seed=3), tr.PrioritizedReplayBuffer(20, D, A, seed=3)
    for i in range(25):
        b = _block(rng, 1)
        args = (b["s"][0], int(b["a"][0]), float(b["r"][0]), b["s2"][0], bool(b["done"][0]),
                b["mask2"][0])
        jb.push(*args)
        tb.push(*args)
    (b1, i1, w1), (b2, i2, w2) = jb.sample(8, 0.5), tb.sample(8, 0.5)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(w1, w2)
    for k in b1:
        np.testing.assert_array_equal(b1[k], b2[k])
    td = rng.standard_normal(8)
    jb.update_priorities(i1, td)
    tb.update_priorities(i2, td)
    np.testing.assert_array_equal(jb.tree, tb.tree)


# ---------------------------------------------------------------------------
# the agent's training half
# ---------------------------------------------------------------------------

def _jax_params(seed=0):
    return jinit(jax.random.PRNGKey(seed), D, A)


def test_act_batch_matches_jax_with_its_draws():
    params = _jax_params()
    tparams = dqn_params_from_numpy(_np(params), "cpu")
    rng = np.random.default_rng(6)
    obs = rng.standard_normal((64, D)).astype(np.float32)
    mask = rng.random((64, A)) < 0.5
    mask[np.arange(64), rng.integers(0, A, 64)] = True
    for k, eps in enumerate((0.0, 0.3, 1.0)):
        key = jax.random.PRNGKey(k)
        ref = ja.act_batch(params, key, jnp.asarray(obs), jnp.asarray(mask), eps)
        k_bern, k_choice = jax.random.split(key)           # act_batch's split
        u = np.array(jax.random.uniform(k_bern, (64,)))
        scores = np.array(jax.random.uniform(k_choice, mask.shape))
        out = ta.act_batch(tparams, torch.from_numpy(obs), torch.from_numpy(mask), eps,
                           u=torch.from_numpy(u), scores=torch.from_numpy(scores))
        np.testing.assert_array_equal(np.asarray(ref), out.numpy())
        assert mask[np.arange(64), out.numpy()].all()


def _adam_state(seed=0, warm=3):
    """JAX params, target and an Adam state after ``warm`` updates."""
    cfg = ja.DQNConfig()
    params, target = _jax_params(seed), _jax_params(seed + 1)
    opt = ja._adam_init(params)
    rng = np.random.default_rng(seed + 10)
    for _ in range(warm):
        params, opt, _ = ja._dqn_update(params, target, opt, _jb(_block(rng, 32)), cfg)
    return params, target, opt, rng


def _torch_state(params, target, opt):
    tp = dqn_params_from_numpy(_np(params), "cpu")
    tt = dqn_params_from_numpy(_np(target), "cpu")
    topt = {"m": dqn_params_from_numpy(_np(opt["m"]), "cpu"),
            "v": dqn_params_from_numpy(_np(opt["v"]), "cpu"),
            "t": torch.tensor(int(opt["t"]), dtype=torch.int32)}
    return tp, tt, topt


def _assert_tree_close(jtree, ttree, what, atol=1e-6):
    for k in jtree:
        np.testing.assert_allclose(ttree[k].numpy(), np.asarray(jtree[k]), rtol=1e-4, atol=atol,
                                   err_msg=f"{what}[{k}]")


PARAM_ATOL = 1e-5     # 2% of one Adam step at lr = 5e-4 (module docstring)


@pytest.mark.parametrize("warm", [0, 3])
def test_dqn_update_matches_jax(warm):
    cfg = ja.DQNConfig()
    params, target, opt, rng = _adam_state(warm=warm)
    tp, tt, topt = _torch_state(params, target, opt)
    batch = _block(rng, 64)
    jp, jo, jl = ja._dqn_update(params, target, opt, _jb(batch), cfg)
    np_, no, nl = ta._dqn_update(tp, tt, topt, _tb(batch), ta.DQNConfig())
    np.testing.assert_allclose(float(nl), float(jl), rtol=1e-5)
    _assert_tree_close(jp, np_, "params", PARAM_ATOL)
    _assert_tree_close(jo["m"], no["m"], "m")
    _assert_tree_close(jo["v"], no["v"], "v")
    assert int(no["t"]) == int(jo["t"]) == warm + 1
    # the inputs are left as they were
    assert torch.equal(tp["w0"], dqn_params_from_numpy(_np(params), "cpu")["w0"])


def test_dqn_update_per_matches_jax_and_unit_weights_are_uniform():
    cfg = ja.DQNConfig()
    params, target, opt, rng = _adam_state(seed=2)
    tp, tt, topt = _torch_state(params, target, opt)
    batch = _block(rng, 64)
    w = (rng.random(64) * 0.9 + 0.1).astype(np.float32)
    jp, jo, jl, jtd = ja._dqn_update_per(params, target, opt, _jb(batch), jnp.asarray(w), cfg)
    np_, no, nl, ntd = ta._dqn_update_per(tp, tt, topt, _tb(batch), torch.from_numpy(w),
                                          ta.DQNConfig())
    np.testing.assert_allclose(float(nl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(ntd.numpy(), np.asarray(jtd), rtol=1e-5, atol=1e-6)
    _assert_tree_close(jp, np_, "params", PARAM_ATOL)
    # w == 1 is bit-equal to the unweighted update
    p1, _, l1, _ = ta._dqn_update_per(tp, tt, topt, _tb(batch), torch.ones(64), ta.DQNConfig())
    p2, _, l2 = ta._dqn_update(tp, tt, topt, _tb(batch), ta.DQNConfig())
    assert torch.equal(l1, l2) and all(torch.equal(p1[k], p2[k]) for k in p1)


def test_aux_updates_keep_the_trajectory_and_report_telemetry():
    params, target, opt, rng = _adam_state(seed=4)
    tp, tt, topt = _torch_state(params, target, opt)
    batch = _tb(_block(rng, 32))
    cfg = ta.DQNConfig()
    p1, _, l1 = ta._dqn_update(tp, tt, topt, batch, cfg)
    p2, _, l2, td, gn = ta._dqn_update_aux(tp, tt, topt, batch, cfg)
    assert torch.equal(l1, l2) and all(torch.equal(p1[k], p2[k]) for k in p1)
    _, _, _, jtd, jgn = ja._dqn_update_aux(params, target, opt,
                                           {k: jnp.asarray(v.numpy()) for k, v in batch.items()},
                                           ja.DQNConfig())
    np.testing.assert_allclose(float(td), float(jtd), rtol=1e-5)
    np.testing.assert_allclose(float(gn), float(jgn), rtol=1e-4)


def test_schedules_match_jax():
    cfg = ja.DQNConfig(eps_decay_steps=100)
    for steps in (0, 1, 37, 100, 250):
        assert ta.epsilon_at(ta.DQNConfig(eps_decay_steps=100), steps) == pytest.approx(
            ja.epsilon_at(cfg, steps))
        assert ta.beta_at(0.4, steps, 100) == pytest.approx(ja.beta_at(0.4, steps, 100))


@pytest.mark.parametrize("per_alpha", [0.0, 0.6])
def test_agent_explores_observes_and_updates_like_jax(per_alpha):
    """The stateful agent: ε-greedy from the numpy rng, the numpy replay, the
    update and the target sync, from the same state and seed."""
    cfg = ja.DQNConfig(batch_size=16, buffer_size=64, target_sync=3, eps_decay_steps=40)
    jag = ja.DQNAgent(D, A, cfg, seed=5, per_alpha=per_alpha)
    tag = dqn_agent_from_numpy(_np(jag.params), cfg=ta.DQNConfig(**vars(cfg)), seed=5,
                               device="cpu", per_alpha=per_alpha)
    rng = np.random.default_rng(8)
    losses = []
    for step in range(40):
        b = _block(rng, 1)
        s, mask = b["s"][0], b["mask2"][0]
        a_j, a_t = jag.act(s, mask), tag.act(s, mask)
        assert a_j == a_t, step
        for ag, a in ((jag, a_j), (tag, a_t)):
            ag.observe(s, a, float(b["r"][0]), b["s2"][0], bool(b["done"][0]), mask)
        lj, lt = jag.update(), tag.update()
        assert (lj is None) == (lt is None)
        if lj is not None:
            losses.append((lj, lt))
    assert jag.env_steps == tag.env_steps and jag.updates == tag.updates > 0
    assert jag.epsilon == tag.epsilon
    np.testing.assert_allclose([lt for _, lt in losses], [lj for lj, _ in losses], rtol=1e-3)
    _assert_tree_close(jag.target_params, tag.target_params, "target", PARAM_ATOL)


def test_agent_state_carries_across_with_adam():
    params, target, opt, _ = _adam_state(seed=6)
    agent = dqn_agent_from_numpy(_np(params), _np(target),
                                 {"m": _np(opt["m"]), "v": _np(opt["v"]), "t": opt["t"]},
                                 device="cpu")
    assert int(agent.opt["t"]) == 3
    for k in params:
        assert np.array_equal(agent.params[k].numpy(), np.asarray(params[k]))
        assert np.array_equal(agent.target_params[k].numpy(), np.asarray(target[k]))
        assert np.array_equal(agent.opt["v"][k].numpy(), np.asarray(opt["v"][k]))
    copy = ta.DQNAgent(D, A, device="cpu", seed=1)
    copy.load_state(agent)
    assert torch.equal(copy.opt["m"]["w1"], agent.opt["m"]["w1"])
    assert copy.params["w0"].data_ptr() != agent.params["w0"].data_ptr()
