"""Co-scheduler launcher (the paper's online phase as a CLI):

    PYTHONPATH=src python -m repro_torch.launch.schedule --episodes 2000 --window 12

Port of ``repro/launch/schedule.py``: trains (or loads) the DQN agent over
the job zoo, schedules the Q1..Q12 queues, and prints the five-method
comparison with the oracle (paper Fig. 8).  ``--device`` (default
``cuda``) is where the agent trains and acts.

The reference takes ``get_zoo`` and ``trained_agent`` from
``benchmarks/common.py``; the port keeps its own copy of both, with the
same agent cache: ``experiments/agents/w{window}_c{c_max}_e{episodes}``
under the working directory, written by ``repro_torch.checkpoint`` as
``{"params": ...}`` with ``extra={"env_steps": ...}``, so a cache written by
either package loads in the other.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

from repro_torch import checkpoint as ck
from repro_torch.convert import dqn_params_from_numpy
from repro_torch.core import (
    POLICIES, CoScheduleEnv, DQNAgent, DQNConfig, EnvConfig, RLScheduler, TrainConfig,
    make_zoo, paper_queues, summarize, train_agent, validate_schedule,
)

AGENT_DIR = "experiments/agents"
DRYRUN_DIR = "experiments/dryrun"
METHODS = ("time_sharing", "mig_only", "mps_only", "mig_mps_default", "rl", "oracle")


def get_zoo():
    return make_zoo(dryrun_dir=DRYRUN_DIR if os.path.isdir(DRYRUN_DIR) else None)


def trained_agent(zoo, window: int = 12, c_max: int = 4, episodes: int = 2000,
                  device="cuda") -> tuple[DQNAgent, EnvConfig]:
    """Train (or load the cached) DQN agent for a (window, c_max) setting.
    The reference's ``fast`` and ``tag`` options, which no launcher sets,
    are left out: the cache key is the reference's with an empty tag."""
    env_cfg = EnvConfig(window=window, c_max=c_max)
    env = CoScheduleEnv(env_cfg)
    cache = os.path.join(AGENT_DIR, f"w{window}_c{c_max}_e{episodes}")
    try:
        tree, extra, _ = ck.restore(cache, device=None)
    except FileNotFoundError:
        pass
    else:
        agent = DQNAgent(env.state_dim, env.n_actions, DQNConfig(), seed=0, device=device,
                         params=dqn_params_from_numpy(tree["params"], device))
        agent.env_steps = int(extra.get("env_steps", 10**9))
        return agent, env_cfg
    t0 = time.time()
    agent, _ = train_agent(
        zoo, env_cfg,
        TrainConfig(episodes=episodes,
                    eval_every=max(100, episodes // 4),
                    dqn=DQNConfig(eps_decay_steps=max(1500, episodes * 7))),
        device=device,
    )
    ck.save(cache, episodes, {"params": agent.params}, extra={"env_steps": agent.env_steps},
            keep_last=1)
    print(f"train_agent_w{window},{(time.time() - t0) * 1e6 / max(1, episodes):.1f},cached")
    return agent, env_cfg


def main(argv=None) -> dict[str, list[float]]:
    """Prints the comparison table and returns it: each method's
    throughput on each queue, in queue order."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--episodes", type=int, default=2000)
    ap.add_argument("--window", type=int, default=12)
    ap.add_argument("--c-max", type=int, default=4)
    ap.add_argument("--per-kind", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    zoo = get_zoo()
    agent, env_cfg = trained_agent(zoo, args.window, args.c_max, episodes=args.episodes,
                                   device=args.device)
    sched = RLScheduler(agent, env_cfg)
    queues = paper_queues(zoo, window=args.window, per_kind=args.per_kind)

    table = {m: [] for m in METHODS}
    for queue in queues.values():
        for m in METHODS:
            s = sched.schedule(queue) if m == "rl" else POLICIES[m](queue, args.c_max)
            if m == "rl":
                validate_schedule(queue, s, args.c_max)
            table[m].append(summarize(s)["throughput"])
    print(f"{'method':18s} " + " ".join(f"{q:>6s}" for q in queues) + "    AM   max")
    for m in METHODS:
        row = table[m]
        print(f"{m:18s} " + " ".join(f"{v:6.3f}" for v in row) +
              f" {np.mean(row):6.3f} {np.max(row):5.3f}")
    return table


if __name__ == "__main__":
    main()
