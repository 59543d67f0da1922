"""Compared scheduling policies (paper §V-A4) + the exhaustive oracle.

Port of ``repro/core/baselines.py``, copied: it is framework-free.

All baselines are *exhaustive* over their policy class, as in the paper:
optimal group selection via exact set-partition DP over the window, optimal
partition + slot assignment per group by enumeration.

    time_sharing        — singletons, full pod each (the 1.0 baseline)
    mig_only  (C = 2)   — private-slice pairs only [refs 6, 34]
    mps_only  (C<=Cmax) — full-pod fractional shares only
    mig_mps_default     — one fixed hierarchical layout + equal (default) MPS
    oracle              — full table (the upper bound for the RL agent)
"""
from __future__ import annotations

import itertools
from functools import lru_cache

from repro_torch.core.partition import Partition, enumerate_partitions, solo_partition
from repro_torch.core.perfmodel import corun_time, solo_run_time
from repro_torch.core.problem import Schedule
from repro_torch.core.profiles import JobProfile


def _best_for_group(group: list[JobProfile], partitions: list[Partition],
                    max_perms: int | None = None) -> tuple[float, Partition | None, tuple[int, ...]]:
    """Min CoRunTime over partitions of matching arity x slot orderings.

    ``max_perms=None`` enumerates all C! slot orderings — required for the
    oracle to actually be an upper bound (a truncated sweep silently missed
    16 of the 24 orderings for C=4 groups).  Pass a cap only for explicitly
    approximate policies.
    """
    best_t, best_p, best_perm = float("inf"), None, tuple(range(len(group)))
    for p in partitions:
        if p.arity != len(group):
            continue
        perms = itertools.permutations(range(len(group)))
        if max_perms is not None:
            perms = itertools.islice(perms, max_perms)
        for perm in perms:
            t = corun_time([group[i] for i in perm], p)
            if t < best_t:
                best_t, best_p, best_perm = t, p, perm
    return best_t, best_p, best_perm


def exhaustive_schedule(queue: list[JobProfile], c_max: int,
                        partitions: list[Partition],
                        enforce_solo_constraint: bool = True,
                        max_perms: int | None = None) -> Schedule:
    """Exact set-partition DP (O(3^W) submask enumeration) over group costs."""
    W = len(queue)
    solo_part = solo_partition()

    @lru_cache(maxsize=None)
    def group_cost(mask: int) -> tuple[float, object]:
        group = [queue[i] for i in range(W) if mask >> i & 1]
        best_t, best_p, best_perm = _best_for_group(group, partitions, max_perms)
        if len(group) == 1 and best_p is None:
            return solo_run_time(group), (solo_part, (0,))
        if best_p is None:
            return float("inf"), None
        if enforce_solo_constraint and best_t > solo_run_time(group):
            return float("inf"), None
        return best_t, (best_p, best_perm)

    # dp over subsets
    INF = float("inf")
    dp = [INF] * (1 << W)
    choice: list[tuple[int, object] | None] = [None] * (1 << W)
    dp[0] = 0.0
    for mask in range(1, 1 << W):
        low = mask & -mask
        sub = mask
        while sub:
            if sub & low and bin(sub).count("1") <= c_max:
                t, info = group_cost(sub)
                if info is not None and dp[mask ^ sub] + t < dp[mask]:
                    dp[mask] = dp[mask ^ sub] + t
                    choice[mask] = (sub, info)
            sub = (sub - 1) & mask
    # fall back to singletons for any group the policy class can't cover
    sched = Schedule()
    mask = (1 << W) - 1
    while mask:
        if choice[mask] is None:  # pragma: no cover — solo always feasible
            i = mask.bit_length() - 1
            sched.add([queue[i]], solo_part)
            mask ^= 1 << i
            continue
        sub, (p, perm) = choice[mask]
        group = [queue[i] for i in range(W) if sub >> i & 1]
        sched.add([group[i] for i in perm], p)
        mask ^= sub
    return sched


# ---------------------------------------------------------------------------
# Named policies
# ---------------------------------------------------------------------------

def time_sharing(queue: list[JobProfile], c_max: int = 4) -> Schedule:
    solo = solo_partition()
    sched = Schedule()
    for j in queue:
        sched.add([j], solo)
    return sched


def mig_only(queue: list[JobProfile], c_max: int = 4) -> Schedule:
    parts = [p for p in enumerate_partitions(2) if p.style in ("mig",) and p.arity == 2]
    return exhaustive_schedule(queue, 2, parts)


def mps_only(queue: list[JobProfile], c_max: int = 4) -> Schedule:
    parts = [p for p in enumerate_partitions(c_max) if p.style == "mps"]
    return exhaustive_schedule(queue, c_max, parts)


def mig_mps_default(queue: list[JobProfile], c_max: int = 4) -> Schedule:
    """Fixed MIG layout (4+4 units) + default (equal) MPS shares; group
    selection exhaustive (paper: 'MIG partitioning selected so that average
    throughput across queues is maximized; MPS in default mode')."""
    from repro_torch.core.partition import Slice

    parts = [
        Partition((Slice(4, (1.0,)), Slice(4, (1.0,))), "default-C2"),
        Partition((Slice(4, (1.0,)), Slice(4, (0.5, 0.5))), "default-C3"),
        Partition((Slice(4, (0.5, 0.5)), Slice(4, (0.5, 0.5))), "default-C4"),
    ]
    return exhaustive_schedule(queue, c_max, parts)


def oracle(queue: list[JobProfile], c_max: int = 4) -> Schedule:
    return exhaustive_schedule(queue, c_max, enumerate_partitions(c_max))


POLICIES = {
    "time_sharing": time_sharing,
    "mig_only": mig_only,
    "mps_only": mps_only,
    "mig_mps_default": mig_mps_default,
    "oracle": oracle,
}
