#!/usr/bin/env python3
"""Phase 7 of ``chip_smoke.py`` alone: the vectorized simulator on the card.

    python3 tools/vecsim_smoke.py          # on the card
    python3 tools/vecsim_smoke.py --cpu    # a small rehearsal of its logic

Runs ``chip_smoke.phase_vecsim`` with a seeded untrained agent of phase 4's
shape (window 8, c_max 4) in place of phase 4's trained one, so it needs no
training run first: every check of phase 7 applies (the card engine equal
to the heap runs, the sweeps to single runs, the population to each
agent's own sweep, the fleet to the heap fleet, the collector on the card
to the CPU, the queueing-reward retrainer fires and hot-swaps); only the
schedules the agent makes differ.  ``--cpu`` runs the engines on the CPU at
4 traces of 30 arrivals and a one-round retrain (its checks of the card
engine against the CPU then compare the CPU with itself).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="rehearse on the CPU at a small size")
    args = ap.parse_args()
    import torch

    from repro_torch import online
    from repro_torch.core import EnvConfig, make_zoo
    from repro_torch.core.agent import DQNAgent
    from repro_torch.core.env import CoScheduleEnv

    dev = "cpu" if args.cpu else "cuda"
    if args.cpu:
        chip_smoke.SWEEP_TRACES, chip_smoke.ONLINE_ARRIVALS, chip_smoke.SWEEP_CAPACITY = 4, 30, 64
        small = dataclasses.replace(online.default_retrain_online_config(1), traces_per_round=2,
                                    n_arrivals=16, capacity=64, eval_traces=2)
        online.default_retrain_online_config = lambda rounds=8: small
        card = "cpu"
    else:
        card = chip_smoke.phase_card(torch)
    env_cfg = EnvConfig(window=chip_smoke.TRAIN_WINDOW, c_max=4)
    env = CoScheduleEnv(env_cfg)
    agent = DQNAgent(env.state_dim, env.n_actions, seed=0, device=dev)
    trace = online.poisson_trace(make_zoo(), n=chip_smoke.ONLINE_ARRIVALS,
                                 load=chip_smoke.ONLINE_LOAD, seed=0, capacity=1.0)
    cfg = online.SimConfig(window=chip_smoke.TRAIN_WINDOW)
    heap = {"time_sharing": online.ClusterSimulator(online.TimeSharingPolicy(), cfg).run(trace),
            "rl": online.ClusterSimulator(online.RLDispatchPolicy(agent, env_cfg), cfg).run(trace)}
    chip_smoke.phase_vecsim(torch, card, agent, trace, heap, dev=dev)
    chip_smoke.say("vecsim_smoke: phase 7 passed")


if __name__ == "__main__":
    main()
