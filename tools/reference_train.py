#!/usr/bin/env python3
"""Train the JAX package's co-scheduler as ``chip_smoke.py``'s phase 4 trains
the port's, and schedule the same 12 paper queues with it.

    PYTHONPATH=src python3 tools/reference_train.py [--seed 0 ...]

``examples/co_schedule.py``'s training configuration (1500 episodes over 16
envs at window 8, c_max 4, epsilon decaying over 9000 steps) through
``repro.core.train_agent``, then the 12 queues of ``paper_queues(zoo,
window=8)`` scheduled by the trained agent beside time sharing, MPS-only and
the exhaustive oracle, printed as phase 4 prints them.  The reference and
the port draw different random numbers, so the two runs agree in outcome
only; several seeds show the reference's spread.  This script runs the
reference alone and imports nothing of the port.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro.core import (  # noqa: E402
    POLICIES, EnvConfig, RLScheduler, TrainConfig, make_zoo, paper_queues, summarize,
    train_agent, validate_schedule,
)
from repro.core.agent import DQNConfig  # noqa: E402

EPISODES, WINDOW = 1500, 8


def run(seed: int) -> float:
    zoo = make_zoo()
    env_cfg = EnvConfig(window=WINDOW, c_max=4)
    cfg = TrainConfig(episodes=EPISODES, eval_every=EPISODES // 4, batch_envs=16, seed=seed,
                      dqn=DQNConfig(eps_decay_steps=EPISODES * 6))
    t0 = time.perf_counter()
    agent, hist = train_agent(zoo, env_cfg, cfg)
    wall = time.perf_counter() - t0
    for rec in hist:
        print(f"[ref seed {seed}] {json.dumps(rec)}", flush=True)
    print(f"[ref seed {seed}] {hist[-1]['episode']} episodes in {wall:.1f} s, "
          f"{agent.updates} updates", flush=True)
    sched = RLScheduler(agent, env_cfg)
    print(f"[ref seed {seed}] {'queue':6s} {'time_sharing':>12s} {'mps_only':>9s} "
          f"{'rl':>7s} {'oracle':>7s}")
    rl = []
    for qname, queue in paper_queues(zoo, window=WINDOW).items():
        s_rl = sched.schedule(queue)
        validate_schedule(queue, s_rl, env_cfg.c_max)
        row = [summarize(POLICIES["time_sharing"](queue, 4))["throughput"],
               summarize(POLICIES["mps_only"](queue, 4))["throughput"],
               summarize(s_rl)["throughput"],
               summarize(POLICIES["oracle"](queue, 4))["throughput"]]
        print(f"[ref seed {seed}] {qname:6s} {row[0]:12.3f} {row[1]:9.3f} {row[2]:7.3f} "
              f"{row[3]:7.3f}", flush=True)
        rl.append(row[2])
    mean_rl = float(np.mean(rl))
    print(f"[ref seed {seed}] mean rl throughput {mean_rl:.3f} (time sharing = 1.0)",
          flush=True)
    return mean_rl


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, nargs="+", default=[0])
    args = ap.parse_args()
    means = {seed: run(seed) for seed in args.seed}
    print(json.dumps({"reference_mean_rl": means}))


if __name__ == "__main__":
    main()
