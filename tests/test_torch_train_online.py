"""The port's ``train_online`` (sim-in-the-loop training on the queueing
reward) against the reference's parts, and on its own.

* ``_stitch_transitions`` (host numpy, copied): the port's and the
  reference's give the same transitions on the same rollout arrays,
  exactly.
* ``_online_updater``: the reference's jitted K-update loop against the
  port's Python loop on the same ring and the same sampled indices (the
  reference's ``jax.random`` draws handed to the port), at
  ``tests/test_torch_replay_agent.py``'s tolerances.
* ``train_online``: deterministic under its seed, the PBT history's shape,
  the warm-start elitism guard, the PER path, config validation — on the
  CPU at a tiny size (JAX's streams cannot be reproduced in torch, so the
  loop itself is held on outcome, as ``tests/test_train_online.py`` holds
  the reference's).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import agent as ja
from repro.core import replay as jr
from repro.core import train as jt
from repro.online import TrainRollout as JRollout
from repro.online.retrain import default_retrain_online_config as j_default_online
from repro_torch.convert import GOLDEN_WINDOW, dqn_params_from_numpy, load_golden_dqn
from repro_torch.core import make_zoo
from repro_torch.core import replay as tr
from repro_torch.core import train as tt
from repro_torch.core.agent import DQNAgent, DQNConfig
from repro_torch.core.env import CoScheduleEnv, EnvConfig
from repro_torch.online import TRACE_FAMILIES, default_retrain_online_config
from repro_torch.online import vecsim as tv

ZOO = make_zoo(dryrun_dir=None)
ENV = EnvConfig(window=GOLDEN_WINDOW)
_ENV = CoScheduleEnv(ENV)
PARAM_ATOL = 1e-5     # tests/test_torch_replay_agent.py's bound for updated params


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The engine is thousands of small ops: one intra-op thread does them as
    fast as eight and leaves the cores to the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_cfg(**kw):
    base = dict(rounds=2, traces_per_round=2, n_arrivals=16, capacity=64, window=4,
                population=1, eval_traces=2, updates_per_round=8, eps_decay_rounds=2,
                push_block=8, scenarios=(("poisson", 1.2),),
                dqn=DQNConfig(buffer_size=2048, batch_size=8, eps_decay_steps=500))
    base.update(kw)
    return tt.TrainOnlineConfig(**base)


def _leaves(agent):
    return [agent.params[k] for k in sorted(agent.params)]


# ------------------------------------------------------------- stitching

def _stitch_both(arrays, n_windows, makespan, **cfg_kw):
    jx = jt._stitch_transitions(JRollout(**arrays), n_windows, makespan,
                                jt.TrainOnlineConfig(**cfg_kw))
    tx = tt._stitch_transitions(tv.TrainRollout(**{k: torch.as_tensor(v)
                                                   for k, v in arrays.items()}),
                                n_windows, makespan, tt.TrainOnlineConfig(**cfg_kw))
    return jx, tx


@pytest.mark.parametrize("case", ["folded", "leading", "none"])
def test_stitch_matches_the_reference(case):
    rng = np.random.default_rng(3)
    valid = {"folded": [[1, 0], [0, 0], [1, 1], [1, 1]],
             "leading": [[0, 0], [1, 0], [1, 1], [0, 0]],
             "none": [[0, 0]] * 4}[case]
    arrays = {"obs": rng.standard_normal((4, 2, 3)).astype(np.float32),
              "act": rng.integers(0, 4, (4, 2)).astype(np.int32),
              "mask": rng.random((4, 2, 4)) < 0.7,
              "valid": np.array(valid, bool),
              "w_wait": rng.random(4).astype(np.float32) * 50,
              "w_turn": rng.random(4).astype(np.float32) * 90}
    for kw in ({}, {"n_arrivals": 10, "turnaround_weight": 0.5, "makespan_weight": 2.0}):
        jx, tx = _stitch_both(arrays, 3, 50.0, **kw)
        if case == "none":
            assert jx is None and tx is None
            continue
        assert jx.keys() == tx.keys()
        for k in jx:
            assert tx[k].dtype == jx[k].dtype, k
            np.testing.assert_array_equal(tx[k], jx[k], err_msg=k)


def test_stitch_matches_the_reference_on_a_collected_rollout():
    """A rollout of the port's collector (golden agent, ε = 0.3) stitched by
    both packages."""
    traces = [TRACE_FAMILIES["poisson"](ZOO, n=24, load=1.3, seed=s) for s in range(2)]
    names, jobs = {}, []
    batch = tv.stack_traces([tv.compile_trace(t, 64, names, jobs, device="cpu")[0]
                             for t in traces])
    collect = tv.make_rollout_collector(ENV, window=4, capacity=64, device="cpu")
    summ, roll = collect(batch, tv.build_rl_job_table(jobs, "cpu"),
                         load_golden_dqn("tests/golden/train_agent_proxy_v1.npz", "cpu").params,
                         0.3, torch.full((2,), 8), generator=torch.Generator().manual_seed(4))
    for lane in range(2):
        arrays = {f: getattr(roll, f)[lane].numpy() for f in roll._fields}
        jx, tx = _stitch_both(arrays, int(summ.dispatches[lane]), float(summ.makespan[lane]),
                              n_arrivals=24, turnaround_weight=0.25)
        assert len(tx["a"]) > 0
        for k in jx:
            np.testing.assert_array_equal(tx[k], jx[k], err_msg=k)


# ---------------------------------------------------------- update engine

def _ring_pair(rng, d, n_act, cap, n, per):
    block = {"s": rng.standard_normal((n, d)).astype(np.float32),
             "a": rng.integers(0, n_act, n).astype(np.int32),
             "r": (rng.standard_normal(n) * 50).astype(np.float32),
             "s2": rng.standard_normal((n, d)).astype(np.float32),
             "done": (rng.random(n) < 0.2).astype(np.float32),
             "mask2": rng.random((n, n_act)) < 0.7}
    block["mask2"][:, 0] = True
    jb = {k: jnp.asarray(v) for k, v in block.items()}
    tb = {k: torch.from_numpy(v.copy()) for k, v in block.items()}
    tb["a"] = tb["a"].long()
    if per:
        return jr.per_push(jr.per_init(cap, d, n_act), jb), tr.per_push(
            tr.per_init(cap, d, n_act, "cpu"), tb)
    return jr.replay_push(jr.replay_init(cap, d, n_act), jb), tr.replay_push(
        tr.replay_init(cap, d, n_act, "cpu"), tb)


@pytest.mark.parametrize("per", [None, (0.6, 1e-3)])
def test_online_updater_matches_the_reference(per):
    """Three updates with a target sync every second one, on the same ring
    and the same draws (the reference's key split once an update)."""
    d, n_act, n_up = 12, 7, 3
    cfg = ja.DQNConfig(batch_size=16)
    agent = ja.DQNAgent(d, n_act, cfg, seed=1)
    jring, tring = _ring_pair(np.random.default_rng(2), d, n_act, 64, 64, per)
    key0 = jax.random.PRNGKey(9)
    jout = jt._online_updater(cfg, n_up, 2, per)(
        agent.params, agent.target_params, agent.opt, jring, key0, jnp.int32(0),
        jnp.float32(0.4))
    # the reference's draws: one split a update
    draws, key = [], key0
    for _ in range(n_up):
        key, ks = jax.random.split(key)
        draws.append(torch.as_tensor(np.array(
            jr._uniform_indices(jring, ks, 16) if per is None
            else jax.random.uniform(ks, (16,)))))

    def tree(x):
        return dqn_params_from_numpy({k: np.asarray(v) for k, v in x.items()}, "cpu")

    topt = {"m": tree(agent.opt["m"]), "v": tree(agent.opt["v"]),
            "t": torch.tensor(int(agent.opt["t"]), dtype=torch.int32)}
    p, t, opt, ring, updates = tt._online_updater(DQNConfig(batch_size=16), n_up, 2, per)(
        tree(agent.params), tree(agent.target_params), topt, tring, None, 0, 0.4, draws=draws)
    jp, jtg, jopt, jring2, _, jupd = jout
    assert updates == int(jupd) == n_up
    for name, jtree, ttree, atol in (("params", jp, p, PARAM_ATOL), ("target", jtg, t, PARAM_ATOL),
                                     ("m", jopt["m"], opt["m"], 1e-6),
                                     ("v", jopt["v"], opt["v"], 1e-6)):
        for k in jtree:
            np.testing.assert_allclose(ttree[k].numpy(), np.asarray(jtree[k]), rtol=1e-4,
                                       atol=atol, err_msg=f"{name}[{k}]")
    # the sync at update 2 copied the params of update 2, not of update 3
    assert not torch.equal(t["w0"], p["w0"])
    if per is not None:
        np.testing.assert_allclose(ring.tree.numpy(), np.asarray(jring2.tree), rtol=1e-4)


# ------------------------------------------------------------ train_online

def test_train_online_deterministic_and_its_history():
    cfg = _tiny_cfg()
    a0, h0 = tt.train_online(ZOO, ENV, cfg, device="cpu")
    a1, h1 = tt.train_online(ZOO, ENV, cfg, device="cpu")
    for x, y in zip(_leaves(a0), _leaves(a1)):
        assert torch.equal(x, y)
    assert h0 == h1
    assert [r["round"] for r in h0] == [1, 2]
    assert h0[-1]["selected"] == 0 and len(h0[-1]["final_scores"]) == 1
    assert a0.updates > 0 and a0.device == torch.device("cpu")
    # the agent trained: its params left the seed agent's
    seed = DQNAgent(_ENV.state_dim, _ENV.n_actions, cfg.dqn, seed=cfg.seed, device="cpu")
    assert any(not torch.equal(x, y) for x, y in zip(_leaves(a0), _leaves(seed)))
    other, _ = tt.train_online(ZOO, ENV, _tiny_cfg(seed=1), device="cpu")
    assert any(not torch.equal(x, y) for x, y in zip(_leaves(a0), _leaves(other)))


def test_train_online_population_pbt_and_history():
    cfg = _tiny_cfg(rounds=3, population=3, pbt_interval=2,
                    scenarios=(("poisson", 1.2), ("mmpp", 1.3)))
    agent, hist = tt.train_online(ZOO, ENV, cfg, device="cpu")
    assert len(hist) == 3
    assert all(len(r["scores"]) == 3 for r in hist)
    assert [("pbt" in r) for r in hist] == [False, True, False]
    assert all(0 <= d < 3 and 0 <= s < 3 and d != s for d, s in hist[1]["pbt"])
    assert hist[-1]["best_member"] == int(np.argmin(hist[-1]["scores"]))
    assert isinstance(hist[-1]["selected"], int) and len(hist[-1]["final_scores"]) == 3
    assert all(torch.isfinite(x).all() for x in _leaves(agent))


def test_train_online_per_path():
    agent, hist = tt.train_online(ZOO, ENV, _tiny_cfg(per_alpha=0.6), device="cpu")
    assert agent.updates > 0 and agent.per_alpha == 0.6
    assert np.isfinite(hist[-1]["best_p99"])
    uni, _ = tt.train_online(ZOO, ENV, _tiny_cfg(), device="cpu")
    assert any(not torch.equal(x, y) for x, y in zip(_leaves(agent), _leaves(uni)))


def test_train_online_warm_start_elitism_guard():
    """An untrained warm start that no refresh beats is kept, copied: its
    params come back unchanged and the warm agent is left as it was."""
    warm = load_golden_dqn("tests/golden/train_agent_proxy_v1.npz", "cpu")
    before = [x.clone() for x in _leaves(warm)]
    cfg = _tiny_cfg(rounds=1, updates_per_round=2)
    agent, hist = tt.train_online(ZOO, ENV, cfg, warm_start=warm, device="cpu")
    sel, scores = hist[-1]["selected"], hist[-1]["final_scores"]
    assert len(scores) == 2
    assert sel == ("warm_start" if scores[1] <= scores[0] else 0)
    if sel == "warm_start":
        for x, y in zip(before, _leaves(agent)):
            assert torch.equal(x, y)
    for x, y in zip(before, _leaves(warm)):
        assert torch.equal(x, y)
    # with no update at all the population is the warm start: a tie, kept
    agent, hist = tt.train_online(ZOO, ENV, _tiny_cfg(rounds=1, updates_per_round=0),
                                  warm_start=warm, device="cpu")
    assert hist[-1]["selected"] == "warm_start"
    assert hist[-1]["final_scores"][0] == hist[-1]["final_scores"][1]
    for x, y in zip(before, _leaves(agent)):
        assert torch.equal(x, y)


def test_train_online_validates_config_and_device():
    with pytest.raises(ValueError, match="serve window"):
        tt.train_online(ZOO, EnvConfig(window=4), _tiny_cfg(window=8), device="cpu")
    with pytest.raises(ValueError, match="unknown trace family"):
        tt.train_online(ZOO, ENV, _tiny_cfg(scenarios=(("nope", 1.0),)), device="cpu")
    warm = DQNAgent(_ENV.state_dim, _ENV.n_actions, seed=0, device="cpu")
    with pytest.raises(ValueError, match="warm_start agent lives on"):
        tt.train_online(ZOO, ENV, _tiny_cfg(), warm_start=warm, device="meta")


def test_default_retrain_online_config_is_the_reference():
    for rounds in (8, 5, 1):
        a = dataclasses.asdict(default_retrain_online_config(rounds))
        b = dataclasses.asdict(j_default_online(rounds))
        assert a == b
    assert dataclasses.asdict(tt.TrainOnlineConfig()) == dataclasses.asdict(jt.TrainOnlineConfig())
