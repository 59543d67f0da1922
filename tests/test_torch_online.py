"""The port's online heap path against the reference: the same traces,
the same ``SimResult.summary()`` and per-job records, key for key and
exactly (both simulate in Python floats on the same f64 performance
model), for every policy, mode and router below; with telemetry on, the
same lifecycle events, the same registry and the same ``DriftMonitor``
verdicts.  No wall-clock reading is compared (``PhaseTimer`` is not
used).  The RL policy runs the golden agent of
``tests/golden/train_agent_proxy_v1.npz`` at window 4 in both packages
(the reference's forward jitted, the port's on the CPU)."""
import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import online as jo
from repro.core import workloads as jwork
from repro.core.agent import DQNAgent as JAgent
from repro.core.env import EnvConfig as JEnvConfig
from repro_torch import online as to
from repro_torch.convert import DQN_KEYS, GOLDEN_WINDOW, load_golden_dqn
from repro_torch.core import TrainConfig, workloads as twork
from repro_torch.core.agent import DQNConfig
from repro_torch.core.env import EnvConfig as TEnvConfig

GOLDEN = pathlib.Path(__file__).parent / "golden" / "train_agent_proxy_v1.npz"
ZOO = {"j": jwork.make_zoo(dryrun_dir=None), "t": twork.make_zoo(dryrun_dir=None)}
PKG = {"j": jo, "t": to}


def _golden_j():
    agent = JAgent(48, 25, seed=0)
    with np.load(GOLDEN) as z:
        agent.params = {k: jnp.asarray(z[f"param_{i}"]) for i, k in enumerate(DQN_KEYS)}
    return agent


_AGENTS = {"j": _golden_j(), "t": load_golden_dqn(GOLDEN, "cpu")}
_ENV = {"j": JEnvConfig(window=GOLDEN_WINDOW), "t": TEnvConfig(window=GOLDEN_WINDOW)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The engine is thousands of small ops: one intra-op thread does them as
    fast as eight and leaves the cores to the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _policy(which: str, side: str):
    o = PKG[side]
    if which == "rl":
        return o.RLDispatchPolicy(_AGENTS[side], _ENV[side])
    if which == "time_sharing":
        return o.TimeSharingPolicy()
    if which == "greedy_packer":
        return o.GreedyPackerPolicy()
    return o.StaticPartitionPolicy(which, c_max=3)


def _trace(side, family="poisson", n=40, seed=3, **kw):
    return PKG[side].TRACE_FAMILIES[family](ZOO[side], n=n, load=1.3, seed=seed, **kw)


def _arrival(a):
    p = a.profile
    return (a.t, a.binary, p.name, p.job_class, p.steps, p.requested_units,
            dict(p.meta))


def _run(side, which, cfg_kw, family="poisson", n=40, seed=3, **sim_kw):
    o = PKG[side]
    sim = o.ClusterSimulator(_policy(which, side), o.SimConfig(**cfg_kw), **sim_kw)
    return sim.run(_trace(side, family, n, seed))


def _same_result(rj, rt):
    assert rt.summary() == rj.summary()
    assert [dataclasses.asdict(r) for r in rt.jobs] == [dataclasses.asdict(r) for r in rj.jobs]
    assert [dataclasses.asdict(s) for s in rt.timeline] == \
        [dataclasses.asdict(s) for s in rj.timeline]


@pytest.mark.parametrize("family", sorted(jo.TRACE_FAMILIES))
def test_trace_families_match_reference(family):
    assert sorted(to.TRACE_FAMILIES) == sorted(jo.TRACE_FAMILIES)
    for kw in ({}, {"mix": "ci", "capacity": 2.0}):
        tj, tt = _trace("j", family, 60, 5, **kw), _trace("t", family, 60, 5, **kw)
        assert [_arrival(a) for a in tt] == [_arrival(a) for a in tj]


@pytest.mark.parametrize("mode", ["concurrent", "blocking"])
@pytest.mark.parametrize("which", ["time_sharing", "greedy_packer", "mig_only", "rl"])
def test_single_pod_policies_match_reference(which, mode):
    cfg = dict(window=GOLDEN_WINDOW, mode=mode)
    rj, rt = _run("j", which, cfg), _run("t", which, cfg)
    _same_result(rj, rt)
    assert rt.summary()["jobs"] == 40 and rt.summary()["policy"] == which


@pytest.mark.parametrize("router", ["hash", "least_loaded", "frag"])
def test_fleet_routers_match_reference(router):
    """A heterogeneous (8, 8, 4, 4) fleet on the fragmented trace (sub-pod
    width requests), served by the RL policy and the greedy packer."""
    cfg = dict(window=GOLDEN_WINDOW, pods=(8, 8, 4, 4), router=router)
    for which in ("rl", "greedy_packer"):
        rj = _run("j", which, cfg, family="fragmented", n=48, seed=2)
        rt = _run("t", which, cfg, family="fragmented", n=48, seed=2)
        _same_result(rj, rt)
        assert rt.summary()["n_pods"] == 4


class _DriftTap:
    """A tick callback that feeds a ``DriftMonitor`` as the retrainer's
    drift trigger does, and records every verdict."""

    def __init__(self, side):
        self.monitor = PKG[side].DriftMonitor(min_arrivals=4)
        self.last = 0.0

    def __call__(self, now, sim):
        cc, wc = {}, {}
        for a in sim.live_arrivals(self.last, now):
            cc[a.profile.job_class] = cc.get(a.profile.job_class, 0) + 1
            wc[a.profile.requested_units] = wc.get(a.profile.requested_units, 0) + 1
        self.last = now
        if self.monitor.observe(cc, wc, sim.live_idle_frac())["drift"]:
            self.monitor.rebase()


def test_telemetry_events_registry_and_drift_verdicts_match_reference():
    """Telemetry on, a tick every simulated 10 minutes on a diurnal trace:
    the event stream, the registry, the drift verdicts and the time series
    equal the reference's; the registry's aggregates equal ``summary()``,
    as the reference's ``test_registry_counters_match_summary`` holds."""
    out = {}
    for side in ("j", "t"):
        tel, tap = PKG[side].Telemetry(), _DriftTap(side)
        res = _run(side, "rl", dict(window=GOLDEN_WINDOW, pods=(8, 4), router="hash",
                                    tick_interval_s=600.0),
                   family="diurnal", n=60, seed=4, on_tick=tap, telemetry=tel)
        out[side] = (res, tel, tap)
    (rj, tj, dj), (rt, tt, dt) = out["j"], out["t"]
    _same_result(rj, rt)
    assert rt.ticks > 3
    assert tt.recorder.events == tj.recorder.events
    assert len(tt.recorder.by_kind("arrive")) == 60
    assert {e["kind"] for e in tt.recorder.events} >= {"arrive", "window", "place", "free",
                                                       "tick"}
    assert tt.metrics.to_dicts() == tj.metrics.to_dicts()
    assert dt.monitor.history == dj.monitor.history
    assert any(v["drift"] for v in dt.monitor.history)
    assert rt.timeseries() == rj.timeseries()
    summ, m = rt.summary(), {d["name"]: d for d in tt.metrics.to_dicts()}
    assert m["jobs_arrived"]["value"] == summ["jobs"]
    assert m["windows_formed"]["value"] == summ["dispatches"]
    assert m["groups_placed"]["value"] == summ["groups"]
    assert m["backfills"]["value"] == summ["backfills"]
    assert m["wait_s"]["count"] == summ["jobs"]
    assert m["wait_s"]["sum"] == pytest.approx(sum(r.wait for r in rt.jobs), rel=1e-9)
    assert m["busy_unit_s"]["value"] == pytest.approx(sum(rt.slice_busy_s), rel=1e-9)


def test_retrainer_fires_and_hot_swaps():
    """On outcome, as the reference's ``test_retrainer_fires_and_hot_swaps_params``:
    the retrainer fires, every cycle trains on enough jobs and evaluates to
    a finite throughput, the policy then serves another agent, and the
    original agent's parameters are untouched (warm start copies)."""
    agent = load_golden_dqn(GOLDEN, "cpu")
    before = {k: v.clone() for k, v in agent.params.items()}
    trace = to.poisson_trace(ZOO["t"], n=30, load=1.3, seed=7)
    pol = to.RLDispatchPolicy(agent, _ENV["t"])
    cfg = TrainConfig(episodes=20, eval_every=20, n_train_queues=2, n_heldout_queues=0,
                      strict_classes=False, batch_envs=4, update_every=4,
                      dqn=DQNConfig(buffer_size=512, batch_size=32, eps_decay_steps=400))
    rt = to.OnlineRetrainer(policy=pol, train_cfg=cfg, interval_s=trace[-1].t / 3.0,
                            min_jobs=3)
    res = to.ClusterSimulator(pol, window=GOLDEN_WINDOW, tick_interval_s=rt.interval_s,
                              on_tick=rt).run(trace)
    assert res.ticks >= 1 and len(rt.history) >= 1
    for h in rt.history:
        assert h["repository_jobs"] >= 3 and h["episodes"] >= 20
        assert np.isfinite(h["train_eval_throughput"])
    assert pol.agent is not agent and pol.agent.device == agent.device
    assert any(not torch_equal(pol.agent.params[k], before[k]) for k in before)
    for k, v in before.items():
        assert torch_equal(agent.params[k], v)


def torch_equal(a, b) -> bool:
    return bool((a == b).all())


def test_queueing_reward_is_refused():
    """Only an unknown reward is refused now: ``reward="queueing"`` runs the
    port's ``train_online`` (on the serving agent's device, warm-started
    from it) at each tick and hot-swaps the refreshed agent; the serving
    agent's own parameters are left as they were (the warm start copies)."""
    pol = to.RLDispatchPolicy(load_golden_dqn(GOLDEN, "cpu"), _ENV["t"])
    with pytest.raises(ValueError):
        to.OnlineRetrainer(policy=pol, reward="latency")
    agent = pol.agent
    before = {k: v.clone() for k, v in agent.params.items()}
    trace = to.poisson_trace(ZOO["t"], n=24, load=1.3, seed=7)
    ocfg = dataclasses.replace(
        to.default_retrain_online_config(rounds=1), traces_per_round=2, n_arrivals=16,
        capacity=64, eval_traces=2, updates_per_round=4, push_block=8,
        dqn=DQNConfig(buffer_size=512, batch_size=8))
    rt = to.OnlineRetrainer(policy=pol, reward="queueing", online_cfg=ocfg,
                            interval_s=trace[-1].t / 2.0, min_jobs=3)
    res = to.ClusterSimulator(pol, window=GOLDEN_WINDOW, tick_interval_s=rt.interval_s,
                              on_tick=rt).run(trace)
    assert res.ticks >= 1 and len(rt.history) >= 1
    for h in rt.history:
        assert h["rounds"] == 1 and np.isfinite(h["train_eval_p99_wait"])
        assert h["selected"] in ("warm_start", 0)
        assert "train_eval_throughput" not in h
    assert pol.agent is not agent and pol.agent.device == agent.device
    for k, v in before.items():
        assert torch_equal(agent.params[k], v)
