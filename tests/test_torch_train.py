"""The port's training loops against the JAX package: the scalar loop step
by step, the batched loop on outcome.

The scalar training loop shares every random stream with the reference
(numpy generators), so its actions, replay contents and records are equal,
and its parameters are within rtol 1e-3 / atol 1e-4 of the reference's
after all updates (each update's rounding differences carry into the next).
The batched loop draws from torch generators and is held on outcome:
``tests/test_system.py``'s bar, at its configuration
(``tests/test_torch_train_engine.py`` holds its contract).
"""
import numpy as np
import pytest
import torch

from repro.core import train as jtrain
from repro.core.agent import DQNAgent as JDQNAgent
from repro.core.agent import DQNConfig as JDQNConfig
from repro.core.env import EnvConfig as JEnvConfig
from repro.core.workloads import make_zoo as jmake_zoo
from repro_torch.convert import dqn_agent_from_numpy
from repro_torch.core import EnvConfig, RLScheduler, make_zoo, paper_queues, validate_schedule
from repro_torch.core.agent import DQNConfig
from repro_torch.core.baselines import POLICIES
from repro_torch.core.metrics import summarize
from repro_torch.core.train import TrainConfig, train_agent, train_agent_scalar

ZOO, JZOO = make_zoo(dryrun_dir=None), jmake_zoo(dryrun_dir=None)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The engine's tensors are tiny; intra-op threads only add overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the scalar training loop, step by step
# ---------------------------------------------------------------------------

def test_train_agent_scalar_steps_like_jax():
    env_cfg, jenv_cfg = EnvConfig(window=4, c_max=3), JEnvConfig(window=4, c_max=3)
    kw = dict(episodes=12, eval_every=4, n_train_queues=4, seed=3)
    dqn = dict(batch_size=16, buffer_size=256, target_sync=10, eps_decay_steps=60)
    jagent, jhist = jtrain.train_agent_scalar(
        JZOO, jenv_cfg, jtrain.TrainConfig(dqn=JDQNConfig(**dqn), **kw))
    # the reference's initial network, carried across
    init = JDQNAgent(jagent.params["w0"].shape[0], jagent.params["wA"].shape[1],
                     JDQNConfig(**dqn), seed=3)
    start = dqn_agent_from_numpy({k: np.asarray(v) for k, v in init.params.items()},
                                 device="cpu")
    agent, hist = train_agent_scalar(ZOO, env_cfg, TrainConfig(dqn=DQNConfig(**dqn), **kw),
                                     device="cpu", warm_start=start)
    assert agent.env_steps == jagent.env_steps and agent.updates == jagent.updates > 0
    n = len(agent.replay)
    assert n == len(jagent.replay)
    for f in ("a", "s", "s2", "done", "mask2"):          # the same actions, states
        np.testing.assert_array_equal(getattr(agent.replay, f)[:n],
                                      getattr(jagent.replay, f)[:n], err_msg=f)
    np.testing.assert_allclose(agent.replay.r[:n], jagent.replay.r[:n], rtol=1e-6, atol=1e-6)
    assert [h["episode"] for h in hist] == [h["episode"] for h in jhist]
    for h, jh in zip(hist, jhist):
        assert h["eval_throughput"] == pytest.approx(jh["eval_throughput"], rel=1e-9)
        assert h["ep_reward"] == pytest.approx(jh["ep_reward"], rel=1e-9)
    for k in agent.params:
        np.testing.assert_allclose(agent.params[k].numpy(), np.asarray(jagent.params[k]),
                                   rtol=1e-3, atol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# the batched training loop
# ---------------------------------------------------------------------------

def test_train_agent_reaches_the_system_bar_on_cpu():
    """``tests/test_system.py``'s configuration and bar: valid schedules,
    at or under the oracle, mean paper-queue throughput above 1.1."""
    env_cfg = EnvConfig(window=6, c_max=4)
    agent, hist = train_agent(ZOO, env_cfg, TrainConfig(
        episodes=400, eval_every=200, n_train_queues=8, dqn=DQNConfig(eps_decay_steps=2500)),
        device="cpu")
    assert hist[-1]["episode"] >= 400
    sched = RLScheduler(agent, env_cfg)
    tps = []
    for queue in paper_queues(ZOO, window=6, per_kind=1).values():
        s = sched.schedule(queue)
        validate_schedule(queue, s, env_cfg.c_max)
        tp = summarize(s)["throughput"]
        assert tp <= summarize(POLICIES["oracle"](queue, env_cfg.c_max))["throughput"] + 1e-6
        tps.append(tp)
    assert float(np.mean(tps)) > 1.1, tps
