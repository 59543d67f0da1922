"""The paper's §IV-A optimization problem in executable form.

    given   W, Cmax, Q = {J_1..J_W}
    min     Σ_i CoRunTime(JS_i, R_i)
    s.t.    CoRunTime(JS_i, R_i) <= SoloRunTime(JS_i)      (no worse than time sharing)
            1 <= C_i = |JS_i| <= Cmax
            |L_JS| = |L_R|,  ∪ JS_i = Q,  Σ|JS_i| = W      (exclusive + exhaustive)
    output  L_JS, L_R
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.partition import Partition
from repro_torch.core.perfmodel import corun, corun_time, solo_run_time
from repro_torch.core.profiles import JobProfile


@dataclass
class Schedule:
    """A solution: groups (L_JS) with partitions (L_R), jobs slot-ordered."""

    groups: list[list[JobProfile]] = field(default_factory=list)   # L_JS
    partitions: list[Partition] = field(default_factory=list)      # L_R

    def add(self, group: list[JobProfile], partition: Partition) -> None:
        assert len(group) == partition.arity
        self.groups.append(group)
        self.partitions.append(partition)

    @property
    def total_corun_time(self) -> float:
        return sum(corun_time(g, p) for g, p in zip(self.groups, self.partitions))

    @property
    def total_solo_time(self) -> float:
        return sum(solo_run_time(g) for g in self.groups)

    def throughput_vs_time_sharing(self) -> float:
        """Paper Fig. 8 metric: relative throughput vs pure time sharing."""
        t = self.total_corun_time
        return self.total_solo_time / t if t > 0 else 0.0

    def app_slowdowns(self) -> dict[str, float]:
        """AppSlowdown(J) = CoRunAppTime(J) / SoloRunAppTime(J) (paper §V-B)."""
        out = {}
        for g, p in zip(self.groups, self.partitions):
            res = corun(g, p)
            for job, ft, st in zip(g, res.finish_times, res.solo_times):
                out[job.name] = ft / st if st > 0 else 1.0
        return out

    def fairness(self) -> float:
        """min/max AppSlowdown (paper Fig. 12; 1.0 = perfectly fair)."""
        sl = list(self.app_slowdowns().values())
        return min(sl) / max(sl) if sl and max(sl) > 0 else 1.0


def validate_schedule(queue: list[JobProfile], sched: Schedule, c_max: int,
                      enforce_solo_constraint: bool = True) -> None:
    """Assert every constraint of the §IV-A formulation."""
    assert len(sched.groups) == len(sched.partitions), "|L_JS| != |L_R|"
    names = [j.name for g in sched.groups for j in g]
    assert len(names) == len(queue), "Σ|JS_i| != W"
    assert sorted(names) == sorted(j.name for j in queue), "∪JS_i != Q"
    for g, p in zip(sched.groups, sched.partitions):
        assert 1 <= len(g) <= c_max, f"concurrency {len(g)} outside [1,{c_max}]"
        assert len(g) == p.arity, "group size != partition arity"
        if enforce_solo_constraint:
            ct, st = corun_time(g, p), solo_run_time(g)
            assert ct <= st * (1 + 1e-9), (
                f"CoRunTime {ct:.3f} > SoloRunTime {st:.3f} for {p.label}"
            )
