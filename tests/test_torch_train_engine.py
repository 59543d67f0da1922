"""The contract of the port's batched training loop (``train_agent``) at a
tiny configuration on the CPU: determinism under a fixed seed, the history
records' keys, ``heldout_throughput`` without held-out jobs, the prioritized
path with alpha = 0 equal to the uniform one, a warm start from an agent
state carried across from the JAX package, and the loop's counting (steps,
update gate, target syncs, episodes per segment, records) held to the
reference's where episode lengths do not depend on the draws.  Its outcome
at ``tests/test_system.py``'s configuration is in
``tests/test_torch_train.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import agent as jagent
from repro.core import train as jtrain
from repro.core.agent import DQNAgent as JDQNAgent
from repro.core.agent import DQNConfig as JDQNConfig
from repro.core.env import EnvConfig as JEnvConfig
from repro.core.workloads import make_zoo as jmake_zoo
from repro_torch.convert import dqn_agent_from_numpy
from repro_torch.core import EnvConfig, make_zoo
from repro_torch.core.agent import DQNConfig
from repro_torch.core.env import VecCoScheduleEnv
from repro_torch.core import train as ttrain
from repro_torch.core.train import TrainConfig, train_agent

ZOO, JZOO = make_zoo(dryrun_dir=None), jmake_zoo(dryrun_dir=None)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The engine's tensors are tiny; intra-op threads only add overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small_cfg(seed=0, **kw):
    return TrainConfig(episodes=24, eval_every=12, n_train_queues=4, batch_envs=4,
                       update_every=4, seed=seed,
                       dqn=DQNConfig(buffer_size=512, batch_size=32, eps_decay_steps=400), **kw)


SMALL_ENV = EnvConfig(window=4, c_max=3)


def test_train_agent_deterministic_history_contract_and_force_per():
    a1, h1 = train_agent(ZOO, SMALL_ENV, _small_cfg(), device="cpu")
    a2, h2 = train_agent(ZOO, SMALL_ENV, _small_cfg(), device="cpu")
    assert h1 == h2
    assert all(torch.equal(a1.params[k], a2.params[k]) for k in a1.params)
    for rec in h1:
        assert set(rec) == {"episode", "eps", "ep_reward", "eval_throughput",
                            "heldout_throughput"}
        assert np.isfinite(rec["heldout_throughput"])     # the zoo has held-out jobs
    assert h1[-1]["episode"] >= 24 and h1[-1]["eps"] < 1.0
    assert a1.env_steps > 0 and a1.updates > 0
    # alpha = 0 through the PER machinery draws the same indices, weights 1
    a3, h3 = train_agent(ZOO, SMALL_ENV, _small_cfg(), device="cpu", _force_per=True)
    assert h3 == h1 and all(torch.equal(a1.params[k], a3.params[k]) for k in a1.params)


def test_heldout_throughput_none_without_heldout_jobs():
    _, hist = train_agent(ZOO, SMALL_ENV, _small_cfg(seed=2), heldout=set(), device="cpu")
    assert all(rec["heldout_throughput"] is None for rec in hist)


def test_train_agent_warm_start_from_a_jax_agent():
    """A JAX-trained agent (params, target, Adam state) carried across seeds
    the port's run; the caller's agent is left as it was."""
    venv = VecCoScheduleEnv(SMALL_ENV, "cpu")
    cfg = JDQNConfig(buffer_size=512, batch_size=32, eps_decay_steps=400)
    ja = JDQNAgent(venv.state_dim, venv.n_actions, cfg, seed=9)
    rng = np.random.default_rng(9)
    for _ in range(3):                                   # a non-trivial Adam state
        batch = {"s": rng.random((32, venv.state_dim), np.float32),
                 "a": rng.integers(0, venv.n_actions, 32).astype(np.int32),
                 "r": rng.standard_normal(32).astype(np.float32) * 50,
                 "s2": rng.random((32, venv.state_dim), np.float32),
                 "done": np.zeros(32, np.float32),
                 "mask2": np.ones((32, venv.n_actions), bool)}
        ja.params, ja.opt, _ = jagent._dqn_update(
            ja.params, ja.target_params, ja.opt, {k: jnp.asarray(v) for k, v in batch.items()},
            cfg)
    npt = lambda tree: {k: np.asarray(v) for k, v in tree.items()}   # noqa: E731
    start = dqn_agent_from_numpy(npt(ja.params), npt(ja.target_params),
                                 {"m": npt(ja.opt["m"]), "v": npt(ja.opt["v"]), "t": ja.opt["t"]},
                                 device="cpu")
    snap = {k: v.clone() for k, v in start.params.items()}
    a2, h2 = train_agent(ZOO, SMALL_ENV, _small_cfg(seed=3), warm_start=start, device="cpu")
    assert h2 and all(torch.equal(snap[k], start.params[k]) for k in snap)
    assert int(a2.opt["t"]) == 3 + a2.updates
    a3, _ = train_agent(ZOO, SMALL_ENV, _small_cfg(seed=3), device="cpu")
    assert any(not torch.equal(a2.params[k], a3.params[k]) for k in a2.params)
    with pytest.raises(AssertionError, match="warm_start"):
        train_agent(ZOO, EnvConfig(window=5, c_max=3), _small_cfg(), warm_start=start,
                    device="cpu")


def test_train_agent_per_context_and_telemetry_records():
    _, hist = train_agent(ZOO, SMALL_ENV, _small_cfg(seed=4, per_alpha=0.6, telemetry=True,
                                                     obs_context=True), device="cpu")
    for rec in hist:
        assert set(rec) == {"episode", "eps", "ep_reward", "eval_throughput",
                            "heldout_throughput", "loss", "td_abs", "grad_norm", "beta",
                            "updates"}
        assert rec["loss"] is None or np.isfinite(rec["loss"])
        assert 0.6 <= rec["beta"] <= 1.0 and rec["updates"] >= 0
    assert hist[-1]["loss"] is not None and np.isfinite(hist[-1]["eval_throughput"])


# (batch_envs, update_every, extra): one update every 3rd engine step with
# uniform replay; two updates every step with prioritized replay (beta)
@pytest.mark.parametrize("batch_envs,update_every,extra", [
    (3, 8, {}), (6, 4, {"per_alpha": 0.6})])
def test_train_agent_counts_match_jax(monkeypatch, batch_envs, update_every, extra):
    """At c_max = 1 every episode is one select and one close per job, 2W
    steps whatever the actions, so the two loops' counts do not depend on
    their (different) random streams: equal env steps, updates and target
    syncs, the same engine cadence, and records at the same episode counts
    with the same epsilon, beta and update count."""
    kw = dict(episodes=40, eval_every=10, n_train_queues=4, batch_envs=batch_envs,
              update_every=update_every, telemetry=True, **extra)
    # the ring reaches one batch exactly at an update step: a gate off by one
    # transition moves the first update
    dqn = dict(buffer_size=256, batch_size=3 * batch_envs, target_sync=20, eps_decay_steps=300)
    jcalls, tcalls = [], []
    j_engine_for, t_engine_for = jtrain._engine_for, ttrain._engine_for

    def j_spy(*args):
        jcalls.append(args)
        return j_engine_for(*args)

    def t_spy(*args, **kwargs):
        tcalls.append(t_engine_for(*args, **kwargs))
        return tcalls[-1]

    monkeypatch.setattr(jtrain, "_engine_for", j_spy)
    monkeypatch.setattr(ttrain, "_engine_for", t_spy)
    ja, jh = jtrain.train_agent(JZOO, JEnvConfig(window=4, c_max=1),
                                jtrain.TrainConfig(dqn=JDQNConfig(**dqn), **kw))
    ta, th = train_agent(ZOO, EnvConfig(window=4, c_max=1),
                         TrainConfig(dqn=DQNConfig(**dqn), **kw), device="cpu")
    (_, _, _, ups, period, sync, _, _), = jcalls
    eng, = tcalls
    assert (eng.updates_per_scan, eng.update_period, eng.sync_updates) == (ups, period, sync)
    assert (ta.env_steps, ta.updates) == (ja.env_steps, ja.updates) and ta.updates > 0
    # the reference syncs when its update count reaches a multiple of `sync`
    assert eng.syncs == ja.updates // sync > 1
    assert [r["episode"] for r in th] == [r["episode"] for r in jh]
    assert [r["updates"] for r in th] == [r["updates"] for r in jh]
    for got, ref in zip(th, jh):
        assert got["eps"] == pytest.approx(ref["eps"], rel=1e-6)
        assert (got["beta"] is None) == (ref["beta"] is None)
        if ref["beta"] is not None:
            assert got["beta"] == pytest.approx(ref["beta"], rel=1e-6)
        assert (got["heldout_throughput"] is None) == (ref["heldout_throughput"] is None)
