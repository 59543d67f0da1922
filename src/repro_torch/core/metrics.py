"""Evaluation metrics (paper §V-B): relative throughput, slowdown, fairness.

Port of ``repro/core/metrics.py``, copied: it is framework-free.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.problem import Schedule


def relative_throughput(sched: Schedule) -> float:
    """Fig. 8 metric: SoloRunTime(Q) / Σ CoRunTime — 1.0 = time sharing."""
    return sched.throughput_vs_time_sharing()


def avg_app_slowdown(sched: Schedule) -> float:
    """Fig. 11 metric: mean over jobs of CoRunAppTime/SoloRunAppTime."""
    return float(np.mean(list(sched.app_slowdowns().values())))


def fairness(sched: Schedule) -> float:
    """Fig. 12 metric: min/max AppSlowdown."""
    return sched.fairness()


def summarize(sched: Schedule) -> dict:
    return {
        "throughput": relative_throughput(sched),
        "avg_slowdown": avg_app_slowdown(sched),
        "fairness": fairness(sched),
        "groups": len(sched.groups),
        "partitions": [p.label for p in sched.partitions],
    }
