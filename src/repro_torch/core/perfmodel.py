"""Co-run performance model: SoloRunTime / CoRunTime (paper Table I functions).

On real hardware these are measurements; in this CPU-only container they are
backed by a roofline contention model over the same per-job artifacts the
dry-run produces (DESIGN.md §5):

  * compute: a job with Level-2 share β gets β of the slice's MXU quanta
    -> compute term / β (static shares = MPS semantics; idle share is wasted
    when a co-resident finishes early, as on real MPS).
  * memory: co-residents on a slice share its HBM bandwidth. Water-filling
    allocation — each job demands its solo bandwidth utilization; low-demand
    jobs keep full speed (complementary CI+MI mixes co-locate well, paper
    Fig. 3), oversubscribed slices inflate everyone else.
  * collective: private per job (its own sub-ring), with the torus factor
    charged on split slices.
  * quantum-switch overhead: multiplicative (1 + sigma*(n_active-1)) — the
    VMEM/cache refill cost of time multiplexing (MPS context overhead
    analogue).

Jobs finish at different times; a phase simulation advances the group through
completion events, re-solving the bandwidth allocation after each (bandwidth
is physically freed; compute shares stay static).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.partition import Partition, Slice
from repro_torch.core.profiles import JobProfile

SIGMA_QUANTUM = 0.03          # per-extra-co-resident switch overhead
KAPPA_INTERFERENCE = 0.35     # shared-slice HBM/ICI efficiency loss per unit
                              # of co-resident demand (stream mixing; the
                              # contention MIG-style isolation removes — paper Fig. 4)


@dataclass
class CoRunResult:
    makespan: float                      # CoRunTime(JS, R)
    finish_times: list[float]            # per job (CoRunAppTime)
    solo_times: list[float]              # per job (SoloRunAppTime)

    @property
    def solo_total(self) -> float:
        return sum(self.solo_times)

    @property
    def throughput_gain(self) -> float:
        return self.solo_total / self.makespan if self.makespan > 0 else 0.0


def water_fill(demands: list[float], capacity: float = 1.0) -> list[float]:
    """Allocate bandwidth fractions: min(demand, fair share), redistributing
    slack to the hungry (classic water-filling)."""
    n = len(demands)
    if n == 0:
        return []
    alloc = [0.0] * n
    remaining = capacity
    active = list(range(n))
    while active and remaining > 1e-12:
        fair = remaining / len(active)
        sated = [i for i in active if demands[i] - alloc[i] <= fair + 1e-15]
        if sated:
            for i in sated:
                remaining -= demands[i] - alloc[i]
                alloc[i] = demands[i]
            active = [i for i in active if i not in sated]
        else:
            for i in active:
                alloc[i] += fair
            remaining = 0.0
    return alloc


def _slice_step_times(jobs: list[JobProfile], betas: list[float], s: Slice,
                      active: list[bool]) -> list[float]:
    """Current per-step time for each active job on slice `s`.

    HBM bandwidth and ICI link bandwidth are physically shared: each job's
    bandwidth *utilization* (busy-time fraction) is water-filled against unit
    capacity, iterated to a fixed point (stretching a job's step lowers its
    utilization, freeing bandwidth). The latency component of the collective
    chain (tiny payloads) and the κ stream-mixing loss contend without
    consuming bandwidth. Compute is divided by the static β shares.
    """
    n_active = sum(active)
    idx = [j for j in range(len(jobs)) if active[j]]
    base = []
    for j in idx:
        c, m, x = jobs[j].terms(s.units, s.torus_factor)
        base.append({
            "c": c / betas[j], "m": m, "xb": x,
            "xl": jobs[j].coll_latency(s.units),
            "fixed": jobs[j].fixed_latency(s.units) + jobs[j].serial_s,
        })
    shared_mem = s.shared_memory and n_active > 1
    multi = n_active > 1
    mem_t = [b["m"] for b in base]        # memory time under current bw grant
    coll_t = [b["xb"] for b in base]      # collective-bytes time, ditto
    mem_u = [0.0] * len(base)
    coll_u = [0.0] * len(base)

    for _ in range(30):
        st = [max(b["c"], mt, ct + b["xl"]) + b["fixed"]
              for b, mt, ct in zip(base, mem_t, coll_t)]
        mem_u = [min(1.0, b["m"] / t) for b, t in zip(base, st)]
        coll_u = [min(1.0, b["xb"] / t) for b, t in zip(base, st)]
        ma = water_fill(mem_u) if shared_mem else mem_u
        ca = water_fill(coll_u) if multi else coll_u
        delta = 0.0
        for i, (b, u_m, a_m, u_x, a_x) in enumerate(zip(base, mem_u, ma, coll_u, ca)):
            tgt_m = b["m"] / a_m if (shared_mem and a_m > 1e-12 and u_m > a_m + 1e-12) else b["m"]
            tgt_x = b["xb"] / a_x if (multi and a_x > 1e-12 and u_x > a_x + 1e-12) else b["xb"]
            delta += abs(tgt_m - mem_t[i]) + abs(tgt_x - coll_t[i])
            mem_t[i] += 0.5 * (tgt_m - mem_t[i])      # damped toward equilibrium
            coll_t[i] += 0.5 * (tgt_x - coll_t[i])
        if delta < 1e-9:
            break

    out = [float("inf")] * len(jobs)
    for i, (b, mt, ct, j) in enumerate(zip(base, mem_t, coll_t, idx)):
        km = 1.0 + KAPPA_INTERFERENCE * (sum(mem_u) - mem_u[i]) if shared_mem else 1.0
        kx = 1.0 + KAPPA_INTERFERENCE * (sum(coll_u) - coll_u[i]) if multi else 1.0
        t = max(b["c"], mt * km, (ct + b["xl"]) * kx) + b["fixed"]
        if n_active > 1:
            t *= 1.0 + SIGMA_QUANTUM * (n_active - 1)
        out[j] = t
    return out


def _simulate_slice(jobs: list[JobProfile], betas: list[float], s: Slice) -> list[float]:
    """Phase simulation of one slice; returns per-job finish times."""
    n = len(jobs)
    remaining = [float(j.steps) for j in jobs]
    active = [True] * n
    finish = [0.0] * n
    t = 0.0
    for _ in range(n):  # at most n phases
        if not any(active):
            break
        st = _slice_step_times(jobs, betas, s, active)
        # time to next completion
        dt = min(remaining[j] * st[j] for j in range(n) if active[j])
        for j in range(n):
            if active[j]:
                remaining[j] -= dt / st[j]
                if remaining[j] <= 1e-9:
                    active[j] = False
                    finish[j] = t + dt
        t += dt
    return finish


def corun(group: list[JobProfile], partition: Partition) -> CoRunResult:
    """CoRunTime for `group` under `partition` (jobs -> slots in order)."""
    slots = partition.slots
    assert len(group) == len(slots), (len(group), partition.label)
    # bucket group positions by slice (positional, so a job object appearing
    # twice in a group keeps both finish times)
    by_slice: dict[int, tuple[list[int], list[float], Slice]] = {}
    for pos, (si, s, beta) in enumerate(slots):
        bucket = by_slice.setdefault(si, ([], [], s))
        bucket[0].append(pos)
        bucket[1].append(beta)
    finish = [0.0] * len(group)
    for si, (positions, betas, s) in by_slice.items():
        fts = _simulate_slice([group[p] for p in positions], betas, s)
        for pos, ft in zip(positions, fts):
            finish[pos] = ft
    solo = [j.solo_time() for j in group]
    return CoRunResult(makespan=max(finish), finish_times=finish, solo_times=solo)


def corun_time(group: list[JobProfile], partition: Partition) -> float:
    return corun(group, partition).makespan


def solo_run_time(group: list[JobProfile]) -> float:
    """Time-sharing: run one by one with the full pod."""
    return sum(j.solo_time() for j in group)


def best_assignment(group: list[JobProfile], partition: Partition) -> tuple[float, tuple[int, ...]]:
    """Min CoRunTime over job->slot orderings (paper's C! assignment space)."""
    import itertools

    best, best_perm = float("inf"), tuple(range(len(group)))
    for perm in itertools.permutations(range(len(group))):
        t = corun_time([group[i] for i in perm], partition)
        if t < best:
            best, best_perm = t, perm
    return best, best_perm
