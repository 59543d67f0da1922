"""Cluster-level arrival routing: which pod serves a submission.
Port of ``repro/online/router.py`` (pure Python, copied).

The fleet simulator (``ClusterSimulator`` with ``SimConfig.pods`` longer
than one) keeps the whole per-pod dispatch path — FCFS windows, the
first-sight protocol, slice-level first-fit, EASY backfill — unchanged,
and adds exactly one decision above it: at the instant a submission
arrives, a :class:`Router` picks the pod whose pending queue it joins.
Everything downstream is per-pod; a routed job never migrates.

Routers see a :class:`FleetView` — an immutable snapshot of every pod's
width, free-unit mask, queue depths, and claimed units at the arrival
instant — and must be **deterministic** functions of ``(arrival, view,
seed)``: the simulator draws no randomness, so two runs of one trace
produce identical assignments.  Eligibility is width-driven: a submission
requesting ``meta["units"]`` slice units (full pod when unhinted, since
first-sight jobs run solo on a whole pod) may only be routed to pods at
least that wide, which is what keeps heterogeneous 4/8-unit fleets
deadlock-free.

Shipped policies:

    hash          — stateless tenant-affine hashing (CRC-32 of the binary
                    path mixed with the seed, modulo the eligible pods).
                    The only router computable from the trace alone, which
                    is what lets the vectorized engine pre-split a fleet
                    trace into independent per-pod lanes.
    least_loaded  — the pod with the lowest (claimed + queued units) per
                    unit of width; ties break on pod index.
    frag          — fragmentation-scored placement à la the FGD scheduler
                    (arXiv 2512.16099): hypothetically first-fit the
                    requested width onto each pod that can host it *now*
                    and pick the pod whose free space is fragmented least
                    by the placement — mice sink into already-busy or
                    narrow pods, wide aligned holes survive for elephants.
                    Falls back to least-loaded ranking when no pod fits
                    the request immediately.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass

from repro_torch.core.partition import N_UNITS, VALID_WIDTHS


@dataclass(frozen=True)
class PodView:
    """One pod at the routing instant (pod-local units: ``len(free) ==
    width``; offsets into the fleet-wide unit axis are the simulator's
    concern, not the router's)."""

    idx: int
    width: int
    free: tuple[bool, ...]
    pending: int                 # submissions queued, not yet dispatched
    ready: int                   # dispatched groups awaiting slice units
    queue_units: int             # slice units requested by queued work
    busy_units: int              # slice units currently claimed

    @property
    def load(self) -> float:
        """Claimed plus queued units per unit of width — the
        least-loaded ranking key."""
        return (self.busy_units + self.queue_units) / self.width

    @property
    def free_units(self) -> int:
        return sum(self.free)


@dataclass(frozen=True)
class FleetView:
    """Immutable fleet snapshot handed to :meth:`Router.route`."""

    pods: tuple[PodView, ...]
    now_s: float = 0.0


def _first_fit(free, width: int) -> int | None:
    """First buddy-aligned offset where ``width`` consecutive units are
    free — the same alignment rule ``find_offsets`` places with."""
    for off in range(0, len(free) - width + 1, width):
        if all(free[off:off + width]):
            return off
    return None


def aligned_free_slots(free, width: int) -> int:
    """How many aligned width-``width`` requests the mask could host."""
    return sum(1 for off in range(0, len(free) - width + 1, width)
               if all(free[off:off + width]))


def fragmentation_units(free) -> float:
    """Unusable-free measure (FGD-style, unit-denominated): averaged over
    the request widths the pod could serve, the number of free units not
    coverable by an aligned free block of that width.  0 for an empty or
    full pod; placing a mouse mid-pod raises it by stranding the units
    around it for wider requests."""
    total = sum(free)
    if total == 0:
        return 0.0
    widths = [w for w in VALID_WIDTHS if w <= len(free)]
    return sum(total - w * aligned_free_slots(free, w)
               for w in widths) / len(widths)


def _requested_units(arrival) -> int:
    prof = arrival.profile
    return prof.requested_units if prof is not None else N_UNITS


class Router:
    """Deterministic arrival -> pod assignment over a :class:`FleetView`."""

    name = "base"

    def __init__(self, seed: int = 0):
        self.seed = seed

    def eligible(self, arrival, fleet: FleetView) -> list[PodView]:
        """Pods wide enough for the submission's requested width.  A
        fleet whose widest pod matches ``N_UNITS`` (asserted by
        ``SimConfig``) always has at least one eligible pod."""
        req = _requested_units(arrival)
        pods = [p for p in fleet.pods if p.width >= req]
        assert pods, f"no pod fits a {req}-unit request"
        return pods

    def route(self, arrival, fleet: FleetView) -> int:
        raise NotImplementedError


class HashRouter(Router):
    """Stateless tenant-affine hashing: the same binary always lands on
    the same pod (given one fleet shape and seed), independent of cluster
    state — CRC-32, not Python's per-process-salted ``hash``."""

    name = "hash"

    def route(self, arrival, fleet: FleetView) -> int:
        pods = self.eligible(arrival, fleet)
        h = zlib.crc32(arrival.binary.encode("utf-8"))
        h ^= (self.seed * 0x9E3779B1) & 0xFFFFFFFF
        return pods[h % len(pods)].idx


class LeastLoadedRouter(Router):
    """Lowest (claimed + queued units) / width; ties break on pod index."""

    name = "least_loaded"

    def route(self, arrival, fleet: FleetView) -> int:
        pods = self.eligible(arrival, fleet)
        return min(pods, key=lambda p: (p.load, p.idx)).idx


class FragRouter(Router):
    """Fragmentation-scored routing (arXiv 2512.16099's fragmentation
    gradient, adapted to buddy-aligned slice units): among pods that can
    host the requested width *right now*, pick the one where the
    hypothetical first-fit placement increases
    :func:`fragmentation_units` the least (then least load, then index).
    When nothing fits immediately, rank all eligible pods least-loaded."""

    name = "frag"

    def route(self, arrival, fleet: FleetView) -> int:
        req = _requested_units(arrival)
        pods = self.eligible(arrival, fleet)
        best = None
        for p in pods:
            off = _first_fit(p.free, min(req, p.width))
            if off is None:
                continue
            after = list(p.free)
            after[off:off + req] = [False] * req
            delta = fragmentation_units(after) - fragmentation_units(p.free)
            key = (delta, p.load, p.idx)
            if best is None or key < best:
                best = key
        if best is not None:
            return best[2]
        return min(pods, key=lambda p: (p.load, p.idx)).idx


ROUTERS: dict[str, type[Router]] = {
    HashRouter.name: HashRouter,
    LeastLoadedRouter.name: LeastLoadedRouter,
    FragRouter.name: FragRouter,
}


def make_router(name: str, seed: int = 0) -> Router:
    assert name in ROUTERS, f"unknown router {name!r} (have {sorted(ROUTERS)})"
    return ROUTERS[name](seed=seed)
