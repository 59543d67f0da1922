"""Arrival-trace generators for the online cluster simulator.
Port of ``repro/online/traces.py`` (numpy seeds, copied).

Each generator returns a time-sorted ``list[Arrival]``, fully determined by
its seed.  Jobs are drawn from the :mod:`repro_torch.core.workloads` zoo with
class weights that mirror the paper's §V-A2 queue recipes — ``mix`` maps
directly onto the Table V workload categories:

    "balanced"  — CI/MI/US equally likely       (Balanced queues)
    "ci"        — 50% CI, 25% MI, 25% US        (CI-dominant queues)
    "mi" / "us" — analogous dominant mixes

Five arrival processes cover the multi-tenant dynamics MISO-style systems
are evaluated under:

    poisson_trace      — memoryless submissions at a constant rate,
    mmpp_trace         — 2-state Markov-modulated Poisson (bursty: a
                         high-rate burst state and a low-rate lull state),
    diurnal_trace      — sinusoidal day/night rate, sampled by thinning,
    heavy_tailed_trace — Poisson arrivals whose *job scale* is
                         Pareto-distributed: each arrival's step count is
                         multiplied by a power-of-two factor drawn from a
                         heavy tail, creating the elephant-and-mice duration
                         mix real clusters see,
    fragmented_trace   — Poisson arrivals carrying *right-sized slice
                         requests* (``meta["units"]``): each submission asks
                         for the narrowest MIG slice whose solo step time
                         stays within a per-arrival tolerance of the
                         full-pod time, mixing 1-slice mice with 4-slice
                         and full-pod jobs — the fragmentation-stressing
                         family slice-level dispatch and backfill are
                         scored on.

Rates are expressed as a ``load`` factor relative to the mean solo duration
of the job pool: ``load=1.0`` submits work exactly as fast as pure time
sharing could retire it, ``load>1`` saturates the pod so makespan-derived
throughput measures scheduling quality rather than idle time.

Trace families double as the *context regimes* of the arrival-aware
observation (``docs/observation.md``): ``fragmented`` exercises the
busy-unit mask (partial occupancies at almost every dispatch), ``mmpp`` and
``diurnal`` swing the queue-depth and age features between lull and burst,
and ``heavy_tailed`` stretches ages behind elephants — which is why the
``arrival_aware`` benchmark section serves every family through both the
profile-only and the context-trained agent.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.profiles import JobProfile
from repro_torch.online.simulator import Arrival

_CLASS_ORDER = ("CI", "MI", "US")


def _class_weights(mix: str) -> dict[str, float]:
    if mix == "balanced":
        return {c: 1 / 3 for c in _CLASS_ORDER}
    dom = mix.upper()
    assert dom in _CLASS_ORDER, mix
    return {c: 0.5 if c == dom else 0.25 for c in _CLASS_ORDER}


def _job_probs(jobs: list[JobProfile], mix: str) -> np.ndarray:
    """Per-job draw probabilities: class weight split evenly inside a class.

    Classes absent from the pool redistribute their weight proportionally
    (the normalization), so any non-empty pool works with any mix."""
    w = _class_weights(mix)
    by_cls: dict[str, int] = {c: 0 for c in _CLASS_ORDER}
    for j in jobs:
        by_cls[j.job_class] += 1
    p = np.array([w[j.job_class] / by_cls[j.job_class] for j in jobs])
    return p / p.sum()


def _draw_jobs(jobs, n, mix, rng) -> list[JobProfile]:
    p = _job_probs(jobs, mix)
    idx = rng.choice(len(jobs), size=n, p=p)
    return [jobs[i] for i in idx]


def mean_solo_time(jobs: list[JobProfile]) -> float:
    return float(np.mean([j.solo_time() for j in jobs]))


def _rate(jobs: list[JobProfile], load: float, capacity: float = 1.0) -> float:
    """Arrivals/second that submit ``load * capacity`` pods' worth of solo
    work.  ``capacity`` is the serving fleet's size in full-pod
    equivalents (``SimConfig.total_units / N_UNITS``), so ``load`` keeps
    its single-pod meaning — 1.0 saturates the *whole* fleet — and
    ``capacity=1.0`` reproduces the historical rates bit-for-bit."""
    return capacity * load / mean_solo_time(jobs)


def _binary(prof: JobProfile) -> str:
    return f"bin://{prof.name}"


def _assemble(times, picks) -> list[Arrival]:
    return [Arrival(t=float(t), binary=_binary(j), profile=j)
            for t, j in zip(times, picks)]


def poisson_trace(jobs: list[JobProfile], n: int, load: float = 1.2,
                  mix: str = "balanced", seed: int = 0,
                  capacity: float = 1.0) -> list[Arrival]:
    """Constant-rate memoryless submissions.  ``capacity`` scales the rate
    to a fleet of that many full-pod equivalents (all families take it)."""
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.exponential(1.0 / _rate(jobs, load, capacity),
                                      size=n))
    return _assemble(times, _draw_jobs(jobs, n, mix, rng))


def mmpp_trace(jobs: list[JobProfile], n: int, load: float = 1.2,
               burst_factor: float = 4.0, mean_phase_s: float = 600.0,
               mix: str = "balanced", seed: int = 0,
               capacity: float = 1.0) -> list[Arrival]:
    """Bursty 2-state MMPP: alternating burst/lull phases of exponential
    length; the burst state submits ``burst_factor``x the lull rate while
    the *time-average* rate matches ``load``."""
    rng = np.random.default_rng(seed)
    base = _rate(jobs, load, capacity)
    lo = 2.0 * base / (1.0 + burst_factor)        # phases are equally likely
    hi = burst_factor * lo
    times, t, state, phase_end = [], 0.0, 1, 0.0
    while len(times) < n:
        if t >= phase_end:
            state = 1 - state
            phase_end = t + rng.exponential(mean_phase_s)
        t += rng.exponential(1.0 / (hi if state else lo))
        times.append(t)
    return _assemble(times, _draw_jobs(jobs, n, mix, rng))


def diurnal_trace(jobs: list[JobProfile], n: int, load: float = 1.2,
                  amplitude: float = 0.8, period_s: float = 7200.0,
                  mix: str = "balanced", seed: int = 0,
                  capacity: float = 1.0) -> list[Arrival]:
    """Sinusoidal day/night rate lambda(t) = base * (1 + A sin(2 pi t / P)),
    sampled exactly by thinning a dominating Poisson process."""
    assert 0.0 <= amplitude < 1.0
    rng = np.random.default_rng(seed)
    base = _rate(jobs, load, capacity)
    peak = base * (1.0 + amplitude)
    times, t = [], 0.0
    while len(times) < n:
        t += rng.exponential(1.0 / peak)
        lam = base * (1.0 + amplitude * math.sin(2.0 * math.pi * t / period_s))
        if rng.uniform() * peak <= lam:
            times.append(t)
    return _assemble(times, _draw_jobs(jobs, n, mix, rng))


def heavy_tailed_trace(jobs: list[JobProfile], n: int, load: float = 1.2,
                       tail_index: float = 1.3, max_scale: int = 8,
                       mix: str = "balanced", seed: int = 0,
                       capacity: float = 1.0) -> list[Arrival]:
    """Poisson arrivals with Pareto-distributed job scale.

    Each arrival's step count is stretched by a power-of-two factor from a
    Pareto(``tail_index``) tail, capped at ``max_scale``.  Scaled variants
    get distinct names/binaries (``name@x4``), so the profile repository
    treats each scale as its own application — a few elephants dominate the
    submitted work while most jobs stay mice.
    """
    rng = np.random.default_rng(seed)
    picks = _draw_jobs(jobs, n, mix, rng)
    raw = 1.0 + rng.pareto(tail_index, size=n)
    scales = np.minimum(2 ** np.floor(np.log2(raw)).astype(int), max_scale)
    variants: dict[str, JobProfile] = {}
    scaled = []
    for j, s in zip(picks, scales):
        if s <= 1:
            scaled.append(j)
            continue
        key = f"{j.name}@x{int(s)}"
        if key not in variants:
            variants[key] = dataclasses.replace(
                j, name=key, steps=int(j.steps * int(s)), meta=dict(j.meta))
        scaled.append(variants[key])
    # elephants inflate the mean solo work; rate uses the *base* pool so the
    # nominal load stays comparable across trace families
    times = np.cumsum(rng.exponential(1.0 / _rate(jobs, load, capacity),
                                      size=n))
    return _assemble(times, scaled)


def fragmented_trace(jobs: list[JobProfile], n: int, load: float = 1.2,
                     mix: str = "balanced", seed: int = 0,
                     tols: tuple[float, ...] = (1.05, 1.35, 1.65),
                     capacity: float = 1.0) -> list[Arrival]:
    """Poisson arrivals with MISO-style right-sized slice requests.

    Each arrival draws a tolerance from ``tols`` and requests the narrowest
    slice width whose solo step time stays within that tolerance of the
    full-pod step time (:meth:`JobProfile.right_size`): US jobs right-size
    to 1 unit at any tolerance (short collective rings make them *faster*
    on small slices), MI decode lands on 2-4 units at looser tolerances,
    and scalable CI training stays full-pod.  Width-``w`` variants get
    distinct names/binaries (``name@u{w}``) and carry ``meta["units"] = w``
    — the placement hint the slice-level dispatch layer honors — so the
    repository treats each right-sized shape as its own application.

    The resulting mix of 1-slice mice among 4-slice and full-pod jobs is
    exactly the fragmentation stress of the MIG-placement literature: big
    jobs wait for wide aligned ranges while mice trickle into (or, without
    backfill, pile up behind) the gaps.  Arrival times reuse the base
    pool's rate, so nominal load stays comparable across trace families.
    """
    from repro_torch.core.partition import N_UNITS

    rng = np.random.default_rng(seed)
    picks = _draw_jobs(jobs, n, mix, rng)
    tol_idx = rng.integers(0, len(tols), size=n)
    variants: dict[str, JobProfile] = {}
    sized = []
    for j, ti in zip(picks, tol_idx):
        w = j.right_size(tols[ti])
        if w >= N_UNITS:
            sized.append(j)
            continue
        key = f"{j.name}@u{w}"
        if key not in variants:
            variants[key] = dataclasses.replace(
                j, name=key, meta={**j.meta, "units": w})
        sized.append(variants[key])
    times = np.cumsum(rng.exponential(1.0 / _rate(jobs, load, capacity),
                                      size=n))
    return _assemble(times, sized)


TRACE_FAMILIES = {
    "poisson": poisson_trace,
    "mmpp": mmpp_trace,
    "diurnal": diurnal_trace,
    "heavy_tailed": heavy_tailed_trace,
    "fragmented": fragmented_trace,
}
