"""Deterministic discrete-event cluster simulator (paper §IV-B, online phase).
Port of ``repro/online/simulator.py`` (pure Python, copied: its perfmodel,
partition and scheduler imports are the port's).

Models a fleet of pods serving a stream of job submissions over
*simulated* time.  Three event kinds drive the clock, popped from a single
heap in ``(time, kind, seq)`` order; *all* events sharing a timestamp are
drained before any dispatch decision, so simultaneous events resolve
deterministically — coincident arrivals (batch submissions, tied burst
times) all reach their pending queues and can share one dispatch window,
and periodic ticks observe the repository state of the same instant:

    ARRIVE — a job submission is routed to a pod's FCFS pending queue,
    TICK   — a periodic simulated-time hook (the re-training loop's clock),
    FREE   — a dispatched group's slice-range claim expires.

Fleet topology and routing
--------------------------
:class:`SimConfig` fixes the fleet shape: ``pods`` is a tuple of per-pod
slice widths (heterogeneous 4/8-unit fleets are the interesting case; the
default ``(N_UNITS,)`` is the single-pod cluster, bit-compatible with the
simulator before fleets).  At the instant a submission arrives, the configured
:class:`~repro_torch.online.router.Router` (hash / least-loaded /
fragmentation-scored) assigns it a pod from an immutable
:class:`~repro_torch.online.router.FleetView` snapshot; everything downstream —
FCFS windows, the first-sight protocol, slice-level first-fit, EASY
backfill — runs per pod, exactly the single-pod path.  Claims never span
pods, and a routed job never migrates.  Pod widths narrower than
``N_UNITS`` are modeled as a full-width occupancy map whose upper units
are permanently busy, so the placement arithmetic (buddy alignment,
reservation replay) is shared verbatim; the router's width eligibility
(a job requesting ``w`` units only routes to pods at least ``w`` wide)
keeps heterogeneous fleets deadlock-free, and a placement the per-pod
policy planned wider than the pod (e.g. an 8-unit MPS pair on a 4-unit
pod) is decomposed back into right-sized solo placements — counted in
``SimResult.refits``.

Slice-level occupancy (``mode="concurrent"``, the default)
----------------------------------------------------------
Each pod is an occupancy map over its slice units, not a scalar busy
flag.  Whenever slice units are idle and the pod's dispatched-group queue
is empty, the FCFS head of its pending queue (up to ``window``
submissions, as ``(binary, profile)`` pairs) is handed to the policy via
:meth:`~repro_torch.online.policies.DispatchPolicy.decide`, which returns a
:class:`~repro_torch.core.scheduler.DispatchDecision` carrying
:class:`~repro_torch.core.scheduler.Placement`\\ s — co-run groups bound to
(possibly sub-pod, width-fitted) hierarchical partitions.  Each
placement's slices are then first-fitted onto disjoint aligned unit
ranges (:func:`~repro_torch.core.partition.find_offsets`), so independent
groups run **concurrently** on disjoint slices; its FREE event is keyed
by the claimed slice ranges and releases exactly those units when the
group drains.

When the head group does not fit the current free units, it reserves its
earliest feasible start (computed by replaying the outstanding claims'
expiries — no new work is admitted past a blocked head, so the reservation
is exact) and a **backfill** scan lets later groups of the already-
dispatched queue start immediately *iff* they fit the idle units now and
their predicted makespan ends by the head's reserved start — EASY-style
backfill, so jumping the queue can never delay the head.

``mode="blocking"`` recovers the whole-pod semantics bit-compatibly
(it requires a fleet of full-width pods): one window's groups execute
back to back on the full pod and the pod is released only when the whole
block drains.  On traces without sub-pod width hints the two modes
produce identical results (all placements are full-pod, so concurrency
never materializes) — the regression tests pin this equivalence.

Dispatch-time context
---------------------
Every window hand-off carries a :class:`~repro_torch.core.env.DispatchContext`
snapshot of the serving pod at the dispatch instant: the live free-unit
mask (the very list placements are first-fitted against — a narrow pod
reports its missing upper units as busy), each head submission's age
since arrival, and the pending-queue depth left behind.  Policies are
free to ignore it (the heuristic baselines do); an RL policy whose
environment runs with ``EnvConfig.obs_context`` folds it into the
agent's observation, closing the loop that lets the policy *learn*
backfill-like behavior the dispatch layer otherwise supplies by hand —
see ``docs/observation.md`` for the exact feature layout and invariants.

Per-job completion times come from the phase-simulated
:func:`~repro_torch.core.perfmodel.corun` under the fitted partition.  Every
dispatched group appends a :class:`Segment` (carrying its pod, claimed
slice ranges, and a backfill flag) to the occupancy timeline, and
:class:`SimResult` exposes fragmentation metrics on top of it: per-slice
busy time across the fleet-wide unit axis, slice-level utilization, and
the idle-slice-time fraction — packing quality, not just makespan — plus
the wait percentiles (p50/p99) that are the fleet-scale headline.

The simulator itself draws no randomness: given one trace (see
:mod:`repro_torch.online.traces`) and one policy, two runs produce identical
:class:`SimResult`\\ s — determinism lives entirely in the trace seed and
the router seed.
"""
from __future__ import annotations

import heapq
import math
from collections import defaultdict, deque
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.env import DispatchContext
from repro_torch.core.partition import N_UNITS, VALID_WIDTHS, find_offsets, solo_partition
from repro_torch.core.perfmodel import CoRunResult, corun
from repro_torch.core.profiles import JobProfile
from repro_torch.core.scheduler import DispatchDecision, Placement, to_placements
from repro_torch.online.router import FleetView, PodView, Router, make_router

_ARRIVE, _TICK, _FREE = 0, 1, 2          # same-time resolution order


@dataclass(frozen=True)
class SimConfig:
    """Frozen simulation configuration — the whole ``ClusterSimulator``
    parameter surface, including the fleet topology.

    ``pods`` is the tuple of per-pod slice widths (each a MIG-valid
    power-of-two; the widest must be ``N_UNITS`` so unhinted full-pod
    submissions always have an eligible pod).  ``router``/``router_seed``
    select the arrival router (:mod:`repro_torch.online.router`) — irrelevant,
    but still recorded, for single-pod fleets.  ``mode="blocking"``
    (the whole-pod dispatch) requires a uniform full-width fleet."""

    window: int = 8
    mode: str = "concurrent"
    backfill: bool = True
    tick_interval_s: float | None = None
    pods: tuple[int, ...] = (N_UNITS,)
    router: str = "hash"
    router_seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "pods", tuple(self.pods))
        assert self.window >= 1
        assert self.mode in ("concurrent", "blocking"), self.mode
        assert self.pods, "fleet needs at least one pod"
        for w in self.pods:
            assert w in VALID_WIDTHS, f"invalid pod width {w}"
        assert max(self.pods) == N_UNITS, \
            "widest pod must be full-width (unhinted jobs request N_UNITS)"
        if self.mode == "blocking":
            assert all(w == N_UNITS for w in self.pods), \
                "blocking mode models whole-pod dispatch: widths must be N_UNITS"

    @property
    def n_pods(self) -> int:
        return len(self.pods)

    @property
    def total_units(self) -> int:
        return sum(self.pods)


@dataclass(frozen=True)
class Arrival:
    """One submission: at time ``t`` the binary at ``binary`` is handed in.

    ``profile`` is the measurement the cluster *would* obtain by profiling
    the job during its first solo run — the policy only sees it through the
    repository protocol (first sight: solo + insert; afterwards: lookup).
    A ``meta["units"]`` hint on the profile (set by right-sized traces) is
    the slice width the submission requests from the placement layer —
    and the width the fleet router's eligibility rule keys on.
    """

    t: float
    binary: str
    profile: JobProfile


@dataclass
class Segment:
    """One group's occupancy: [t0, t1) under ``partition`` on pod ``pod``.

    ``slices`` holds the claimed ``(start, width)`` unit ranges in
    pod-local units (empty only for legacy construction); ``backfilled``
    marks groups that jumped a blocked head into idle units via the
    EASY-backfill scan."""

    t0: float
    t1: float
    jobs: int
    partition: str
    slices: tuple[tuple[int, int], ...] = ()
    backfilled: bool = False
    pod: int = 0

    @property
    def units(self) -> int:
        return sum(w for _, w in self.slices)


@dataclass
class JobRecord:
    """Per-submission lifecycle: arrival -> route -> dispatch -> finish.

    ``dispatch`` is the instant the job's *group* starts executing (a
    window's groups can start at different times under slice-level
    dispatch), so ``wait`` covers all queueing delay including queueing
    behind earlier groups of the same window.  ``units`` is the slice width
    the job actually ran on; ``pod`` the fleet pod the router assigned it;
    ``backfilled`` marks jobs whose group was started by the backfill
    scan.  ``idx`` is the job's index in sorted-trace order (the telemetry
    event stream's job key) and ``job_class`` its profile class — both
    feed the drift/time-series signals."""

    binary: str
    name: str
    arrival: float
    solo_time: float
    dispatch: float = math.nan
    finish: float = math.nan
    group_size: int = 0
    partition: str = ""
    units: int = N_UNITS
    backfilled: bool = False
    pod: int = 0
    idx: int = -1
    job_class: str = ""

    @property
    def wait(self) -> float:
        return self.dispatch - self.arrival

    @property
    def turnaround(self) -> float:
        return self.finish - self.arrival


@dataclass
class SimResult:
    """Fleet-level outcome of one (trace, policy) simulation.

    ``slice_busy_s`` spans the fleet-wide unit axis (pod 0's units first,
    then pod 1's, …); ``busy_time`` sums each pod's any-slice-busy span,
    so ``utilization`` is the mean over pods.  ``summary()`` carries
    ``schema: 2`` — consumers detect the fleet-era layout by it."""

    policy: str
    window: int
    jobs: list[JobRecord]
    mode: str = "concurrent"
    timeline: list[Segment] = field(default_factory=list)
    busy_time: float = 0.0
    dispatches: int = 0
    ticks: int = 0
    backfills: int = 0
    slice_busy_s: list[float] = field(default_factory=lambda: [0.0] * N_UNITS)
    pods: tuple[int, ...] = (N_UNITS,)
    router: str = "hash"
    refits: int = 0

    @property
    def n_pods(self) -> int:
        return len(self.pods)

    @property
    def total_units(self) -> int:
        return sum(self.pods)

    @property
    def pod_offsets(self) -> tuple[int, ...]:
        """Each pod's first index on the fleet-wide unit axis."""
        offs, acc = [], 0
        for w in self.pods:
            offs.append(acc)
            acc += w
        return tuple(offs)

    @property
    def makespan(self) -> float:
        """Time the last job drains (includes arrival-limited idle gaps)."""
        return max((j.finish for j in self.jobs), default=0.0)

    @property
    def total_solo_time(self) -> float:
        return sum(j.solo_time for j in self.jobs)

    @property
    def throughput(self) -> float:
        """Makespan-derived: solo work retired per unit of wall clock.

        Pure time sharing on a saturated single pod scores ~1.0 (idle gaps
        pull it below); co-scheduling pushes it above by retiring more than
        one job's solo work per pod-second, and an N-pod fleet serving a
        capacity-scaled trace approaches N."""
        m = self.makespan
        return self.total_solo_time / m if m > 0 else 0.0

    @property
    def utilization(self) -> float:
        """Mean over pods of the makespan fraction that pod was busy."""
        m = self.makespan
        return self.busy_time / (self.n_pods * m) if m > 0 else 0.0

    # ---- fragmentation metrics (slice-level packing quality) --------------

    @property
    def unit_busy_s(self) -> float:
        """Total claimed unit-seconds (Σ per-slice busy time)."""
        return float(sum(self.slice_busy_s))

    @property
    def slice_utilization(self) -> float:
        """Claimed unit-seconds / (total units x makespan): how much of the
        fleet's slice real estate the schedule actually occupied."""
        m = self.makespan
        return self.unit_busy_s / (self.total_units * m) if m > 0 else 0.0

    @property
    def idle_slice_frac(self) -> float:
        """Fraction of slice-time left idle over the makespan — the
        fragmentation cost slice-level dispatch + backfill drives down."""
        m = self.makespan
        return 1.0 - self.slice_utilization if m > 0 else 0.0

    @property
    def per_slice_utilization(self) -> list[float]:
        m = self.makespan
        return [b / m if m > 0 else 0.0 for b in self.slice_busy_s]

    def slice_timeline(self) -> list[list[tuple[float, float]]]:
        """Per-unit busy intervals on the fleet-wide axis, reconstructed
        from the segment timeline (claims release at group drain, so
        segment spans *are* the claims)."""
        out: list[list[tuple[float, float]]] = [[] for _ in range(self.total_units)]
        offs = self.pod_offsets
        for seg in self.timeline:
            base = offs[seg.pod]
            for start, width in seg.slices:
                for u in range(start, start + width):
                    out[base + u].append((seg.t0, seg.t1))
        for iv in out:
            iv.sort()
        return out

    @property
    def mean_wait(self) -> float:
        return float(np.mean([j.wait for j in self.jobs])) if self.jobs else 0.0

    @property
    def mean_turnaround(self) -> float:
        return float(np.mean([j.turnaround for j in self.jobs])) if self.jobs else 0.0

    @property
    def p50_wait(self) -> float:
        return (float(np.percentile([j.wait for j in self.jobs], 50))
                if self.jobs else 0.0)

    @property
    def p99_wait(self) -> float:
        """Tail wait — the fleet-scale headline metric."""
        return (float(np.percentile([j.wait for j in self.jobs], 99))
                if self.jobs else 0.0)

    @property
    def p95_turnaround(self) -> float:
        return (float(np.percentile([j.turnaround for j in self.jobs], 95))
                if self.jobs else 0.0)

    def summary(self) -> dict:
        """JSON-able digest for BENCH_online.json (``schema: 2``: the
        fleet-era layout — adds ``n_pods``/``pods``/``router``/``refits``
        and redefines utilization as the per-pod mean)."""
        return {
            "schema": 2,
            "policy": self.policy,
            "mode": self.mode,
            "n_pods": self.n_pods,
            "pods": list(self.pods),
            "router": self.router,
            "jobs": len(self.jobs),
            "makespan_s": self.makespan,
            "busy_s": self.busy_time,
            "throughput": self.throughput,
            "utilization": self.utilization,
            "slice_utilization": self.slice_utilization,
            "idle_slice_frac": self.idle_slice_frac,
            "backfills": self.backfills,
            "refits": self.refits,
            "mean_wait_s": self.mean_wait,
            "p50_wait_s": self.p50_wait,
            "p99_wait_s": self.p99_wait,
            "mean_turnaround_s": self.mean_turnaround,
            "p95_turnaround_s": self.p95_turnaround,
            "dispatches": self.dispatches,
            "groups": len(self.timeline),
            "mean_group_size": (float(np.mean([s.jobs for s in self.timeline]))
                                if self.timeline else 0.0),
        }

    def timeseries(self, interval_s: float | None = None,
                   n_bins: int = 48) -> dict:
        """Windowed time-series over the makespan — the drift-signal view.

        Post-hoc from the job records and segment timeline (no telemetry
        recorder needed).  ``interval_s`` fixes the bin width (default:
        makespan / ``n_bins``).  Returns parallel lists, one entry per
        interval ``[t0[i], t0[i] + interval)``:

        * ``t0`` — interval start (s);
        * ``arrivals`` — submissions arriving in the interval;
        * ``queue_depth`` — time-mean count of jobs arrived but not yet
          dispatched;
        * ``occupancy`` — claimed unit-time fraction (1 −
          ``idle_slice_frac``);
        * ``idle_slice_frac`` — its complement, the per-interval trend
          :class:`~repro_torch.online.telemetry.DriftMonitor` watches;
        * ``p50_wait_s`` / ``p99_wait_s`` — wait percentiles of jobs
          *dispatched* in the interval (0.0 when none);
        * ``backfill_rate`` — backfilled fraction of those dispatches;
        * ``class_entropy`` / ``width_entropy`` — Shannon entropy (bits)
          of the interval's arrival class / placed-width mix.
        """
        from repro_torch.online.telemetry import entropy_bits
        m = self.makespan
        if m <= 0 or not self.jobs:
            return {k: [] for k in (
                "t0", "arrivals", "queue_depth", "occupancy",
                "idle_slice_frac", "p50_wait_s", "p99_wait_s",
                "backfill_rate", "class_entropy", "width_entropy")}
        if interval_s is None:
            interval_s = m / n_bins
        n = max(1, int(math.ceil(m / interval_s)))
        t0s = [i * interval_s for i in range(n)]
        arrivals = [0] * n
        qd = [0.0] * n
        occ = [0.0] * n
        waits: list[list[float]] = [[] for _ in range(n)]
        bf = [0] * n
        disp = [0] * n
        cls: list[dict] = [defaultdict(int) for _ in range(n)]
        wid: list[dict] = [defaultdict(int) for _ in range(n)]

        def overlap(a0, a1, b):
            return max(0.0, min(a1, t0s[b] + interval_s) - max(a0, t0s[b]))

        for j in self.jobs:
            b = min(int(j.arrival / interval_s), n - 1)
            arrivals[b] += 1
            cls[b][j.job_class or "?"] += 1
            wid[b][j.units] += 1
            if not math.isnan(j.dispatch):
                d = min(int(j.dispatch / interval_s), n - 1)
                waits[d].append(j.wait)
                disp[d] += 1
                bf[d] += int(j.backfilled)
                lo = int(j.arrival / interval_s)
                for b2 in range(lo, min(d, n - 1) + 1):
                    qd[b2] += overlap(j.arrival, j.dispatch, b2) / interval_s
        for seg in self.timeline:
            lo = int(seg.t0 / interval_s)
            hi = min(int(seg.t1 / interval_s), n - 1)
            for b2 in range(lo, hi + 1):
                occ[b2] += seg.units * overlap(seg.t0, seg.t1, b2)
        denom = self.total_units * interval_s
        occupancy = [min(o / denom, 1.0) for o in occ]
        return {
            "t0": t0s,
            "arrivals": arrivals,
            "queue_depth": qd,
            "occupancy": occupancy,
            "idle_slice_frac": [1.0 - o for o in occupancy],
            "p50_wait_s": [float(np.percentile(w, 50)) if w else 0.0
                           for w in waits],
            "p99_wait_s": [float(np.percentile(w, 99)) if w else 0.0
                           for w in waits],
            "backfill_rate": [b / d if d else 0.0 for b, d in zip(bf, disp)],
            "class_entropy": [entropy_bits(c) for c in cls],
            "width_entropy": [entropy_bits(w) for w in wid],
        }


@dataclass
class _Run:
    """A dispatched group awaiting (or holding) slice units on its pod."""

    group: list[JobProfile]
    partition: object                    # Partition (possibly width-fitted)
    recs: list[JobRecord]
    pred: CoRunResult                    # exact times under `partition`
    window_id: int = 0                   # dispatch window this group came from


class _Pod:
    """One pod's mutable serving state (everything the single-pod
    simulator used to keep on ``self``).  A pod narrower than ``N_UNITS``
    is a full-width occupancy map whose upper units start — and stay —
    busy, so the shared placement arithmetic needs no width parameter."""

    __slots__ = ("idx", "width", "offset", "pending", "ready", "busy",
                 "free", "claims", "cid", "n_busy_units", "busy_t0")

    def __init__(self, idx: int, width: int, offset: int):
        self.idx = idx
        self.width = width
        self.offset = offset             # first index on the fleet unit axis
        self.pending: deque = deque()
        self.ready: deque[_Run] = deque()
        self.busy = False                # blocking-mode pod flag
        self.free = [u < width for u in range(N_UNITS)]
        self.claims: dict[int, tuple[tuple[tuple[int, int], ...], float]] = {}
        self.cid = 0
        self.n_busy_units = 0
        self.busy_t0 = 0.0


class ClusterSimulator:
    """Event-driven fleet: routed FCFS admission windows dispatched by a
    policy, one occupancy map per pod.

    Configuration lives in a frozen :class:`SimConfig` (pass ``config=``;
    the historical keyword arguments remain as a legacy construction path
    and simply populate one).  ``mode="concurrent"`` (default) places each
    dispatched group onto disjoint slice-unit ranges so independent groups
    run side by side; ``backfill=True`` additionally lets later groups of
    a pod's dispatched queue jump a blocked head into idle units when
    their predicted finish cannot delay the head's reserved start.
    ``mode="blocking"`` is the whole-pod block dispatch, kept
    bit-compatible for regression.  Fleets longer than one pod route each
    arrival through ``config.router`` at its arrival instant.

    ``on_tick(now, sim)`` fires every ``tick_interval_s`` of simulated time
    while work remains — the MISO-style re-training loop hangs off it (see
    :mod:`repro_torch.online.retrain`); ticks stop as soon as the heap, pending
    queues, and pods are all drained, so simulations always terminate.

    ``telemetry`` (a :class:`~repro_torch.online.telemetry.Telemetry` bundle)
    turns on lifecycle tracing + streaming metrics: every event emits a
    structured record with pod/slice/claim attribution and updates the
    metrics registry (``docs/observability.md``).  ``None`` (the default)
    is the no-op path — one ``is not None`` test per event, results
    bit-identical either way (telemetry observes, never steers).
    """

    def __init__(self, policy, config: SimConfig | None = None, *,
                 window: int = 8, tick_interval_s: float | None = None,
                 on_tick=None, mode: str = "concurrent",
                 backfill: bool = True, pods: tuple[int, ...] | None = None,
                 router: str = "hash", router_seed: int = 0,
                 telemetry=None):
        if config is None:
            config = SimConfig(
                window=window, mode=mode, backfill=backfill,
                tick_interval_s=tick_interval_s,
                pods=tuple(pods) if pods is not None else (N_UNITS,),
                router=router, router_seed=router_seed)
        self.config = config
        self.policy = policy
        self.on_tick = on_tick
        self.telemetry = telemetry
        self._live_res: SimResult | None = None
        self._live_order: list[Arrival] = []
        # legacy attribute mirrors (config is the source of truth)
        self.window = config.window
        self.tick_interval_s = config.tick_interval_s
        self.mode = config.mode
        self.backfill = config.backfill
        self._router: Router = make_router(config.router, config.router_seed)
        self._pods: list[_Pod] = []
        self._reset_pods()

    def _reset_pods(self) -> None:
        self._pods = []
        off = 0
        for i, w in enumerate(self.config.pods):
            self._pods.append(_Pod(i, w, off))
            off += w

    # ------------------------------------------------------------------ run

    def run(self, trace: list[Arrival]) -> SimResult:
        cfg = self.config
        res = SimResult(policy=getattr(self.policy, "name", "policy"),
                        window=cfg.window, jobs=[], mode=cfg.mode,
                        slice_busy_s=[0.0] * cfg.total_units,
                        pods=cfg.pods, router=cfg.router)
        heap: list[tuple[float, int, int, object]] = []
        seq = 0
        # heap/pending carry the sorted-trace *index*, not the Arrival:
        # traces may legitimately reuse one Arrival object (batch
        # submissions), and identity-keyed records would alias
        order = sorted(trace, key=lambda a: a.t)
        records = [JobRecord(binary=a.binary, name=a.profile.name,
                             arrival=a.t, solo_time=a.profile.solo_time(),
                             idx=i, job_class=a.profile.job_class)
                   for i, a in enumerate(order)]
        res.jobs = list(records)
        # live references: tick callbacks (drift-triggered retraining) read
        # the in-progress result/trace through live_result/live_arrivals
        self._live_res, self._live_order = res, order

        def push(t, kind, payload):
            nonlocal seq
            heapq.heappush(heap, (t, kind, seq, payload))
            seq += 1

        for i, a in enumerate(order):
            push(a.t, _ARRIVE, i)
        if cfg.tick_interval_s and trace:
            push(cfg.tick_interval_s, _TICK, None)

        self._reset_pods()
        n_pods = cfg.n_pods

        def work_left():
            return any(p.pending or p.ready or p.busy or p.claims
                       for p in self._pods)

        tel = self.telemetry

        def handle(now, kind, payload):
            if kind == _ARRIVE:
                i = payload
                pidx = (0 if n_pods == 1
                        else self._router.route(order[i],
                                                self._fleet_view(now, order)))
                records[i].pod = pidx
                self._pods[pidx].pending.append(i)
                if tel is not None:
                    # job_class re-derives the perf model on every access
                    # — reuse the value already computed into the record
                    rec = records[i]
                    tel.on_arrive(now, pidx, i, rec.name, rec.job_class,
                                  order[i].profile.requested_units)
            elif kind == _FREE:
                pidx, cid = payload
                pod = self._pods[pidx]
                if cfg.mode == "blocking":
                    pod.busy = False
                else:
                    self._release(now, pod, cid, res)
                if tel is not None:
                    tel.on_free(now, pidx, cid)
            else:  # _TICK — only while work remains (no retrain on a drained
                # cluster), and stop rescheduling once the trace is served
                if heap or work_left():
                    if self.on_tick is not None:
                        self.on_tick(now, self)
                    res.ticks += 1
                    if tel is not None:
                        tel.on_tick(now)
                    push(now + cfg.tick_interval_s, _TICK, None)

        prev_t = 0.0
        qd = bu = 0
        qd_int = bu_int = 0.0
        pods = self._pods
        pod0 = pods[0] if len(pods) == 1 else None   # single-pod fast path
        blocking = cfg.mode == "blocking"
        while heap:
            now, kind, _, payload = heapq.heappop(heap)
            if tel is not None and now > prev_t:
                # event-gap integrals: depth/busy were constant since
                # prev_t.  Accumulated in locals and flushed once after
                # the loop — a per-pop hook call is measurable against
                # the telemetry_overhead gate
                dt = now - prev_t
                if pod0 is not None:
                    qd = len(pod0.pending)
                    bu = (pod0.width if pod0.busy else 0) if blocking \
                        else pod0.n_busy_units
                else:
                    qd = bu = 0
                    for p in pods:
                        qd += len(p.pending)
                        bu += (p.width if p.busy else 0) if blocking \
                            else p.n_busy_units
                qd_int += qd * dt
                bu_int += bu * dt
                prev_t = now
            handle(now, kind, payload)
            # drain every coincident event before considering a dispatch:
            # same-instant arrivals (batch submissions, tied burst times)
            # must all reach the pending queues so one window sees them all
            while heap and heap[0][0] == now:
                _, kind2, _, payload2 = heapq.heappop(heap)
                handle(now, kind2, payload2)
            for pod in self._pods:
                if cfg.mode == "blocking":
                    self._dispatch_blocking(now, pod, res, order, records,
                                            push)
                else:
                    self._service(now, pod, res, order, records, push)
        if tel is not None:
            tel.on_clock_totals(qd_int, bu_int, qd, bu)
        for pod in self._pods:
            assert not pod.claims and not pod.ready, "undrained claims/groups"
        return res

    # ------------------------------------------------------ live snapshots

    @property
    def live_result(self) -> SimResult | None:
        """The in-progress :class:`SimResult` of the current ``run()`` —
        tick callbacks (drift monitoring) read occupancy through it."""
        return self._live_res

    def live_arrivals(self, t0: float, t1: float) -> list[Arrival]:
        """Arrivals with ``t0 < t <= t1`` of the trace being served —
        the drift monitor's per-window class/width sample."""
        return [a for a in self._live_order if t0 < a.t <= t1]

    def live_idle_frac(self) -> float:
        """Instantaneous fraction of fleet units unclaimed — the drift
        monitor's occupancy signal at tick time."""
        if self.config.mode == "blocking":
            busy = sum(p.width if p.busy else 0 for p in self._pods)
        else:
            busy = sum(p.n_busy_units for p in self._pods)
        return 1.0 - busy / self.config.total_units

    # --------------------------------------------------------- fleet view

    def _fleet_view(self, now, order) -> FleetView:
        """Immutable routing snapshot: every pod's width, pod-local free
        mask, queue depths, and claimed/queued units at the arrival
        instant — the router's whole world."""
        views = []
        for p in self._pods:
            if self.config.mode == "blocking":
                free = tuple([not p.busy] * p.width)
                busy_units = p.width if p.busy else 0
            else:
                free = tuple(p.free[:p.width])
                busy_units = p.n_busy_units
            queue_units = sum(r.partition.total_units for r in p.ready)
            queue_units += sum(
                min(order[i].profile.requested_units, p.width)
                for i in p.pending)
            views.append(PodView(idx=p.idx, width=p.width, free=free,
                                 pending=len(p.pending), ready=len(p.ready),
                                 queue_units=queue_units,
                                 busy_units=busy_units))
        return FleetView(pods=tuple(views), now_s=now)

    # ------------------------------------------------ policy entry point

    def _decide(self, subs, ctx) -> DispatchDecision:
        """One call site for the policy: the unified ``decide`` API, with
        a duck-typing adapter for external policies that still only
        implement the legacy ``placements``/``dispatch`` surface."""
        pol = self.policy
        if hasattr(pol, "decide"):
            return pol.decide(subs, context=ctx)
        if hasattr(pol, "placements"):
            return DispatchDecision(
                schedule=None,
                placements=tuple(pol.placements(subs, context=ctx)))
        sched = pol.dispatch(subs, context=ctx)
        return DispatchDecision(schedule=sched,
                                placements=tuple(to_placements(sched)))

    # ----------------------------------------------------- blocking mode

    def _dispatch_blocking(self, now, pod: _Pod, res, order, records,
                           push) -> None:
        """Whole-pod block dispatch — the first event model, verbatim (the
        dispatch context reports the idle full pod, which it is whenever a
        blocking dispatch fires)."""
        if pod.busy or not pod.pending:
            return
        head = [pod.pending.popleft()
                for _ in range(min(self.window, len(pod.pending)))]
        decision = self._decide(
            [(order[i].binary, order[i].profile) for i in head],
            self._dispatch_context(now, pod, head, order,
                                   free=(True,) * N_UNITS))
        sched = decision.schedule
        assert sched is not None, \
            "blocking mode needs a schedule-producing policy"
        by_name: dict[str, deque] = defaultdict(deque)
        for i in head:
            by_name[order[i].profile.name].append(records[i])
        tel = self.telemetry
        if tel is not None:
            tel.on_window(now, pod.idx, head, len(pod.pending))
        t0 = now
        for g, p in zip(sched.groups, sched.partitions):
            block = corun(g, p)
            grecs = []
            for job, ft in zip(g, block.finish_times):
                rec = by_name[job.name].popleft()
                # dispatch = the group's actual start, not the block
                # hand-off: jobs queued behind earlier groups of the same
                # block are still *waiting*, and a policy that forms many
                # sequential groups must not hide that queueing delay
                rec.dispatch = t0
                rec.finish = t0 + ft
                rec.group_size = len(g)
                rec.partition = p.label
                grecs.append(rec)
            res.timeline.append(Segment(t0, t0 + block.makespan, len(g),
                                        p.label, slices=((0, N_UNITS),),
                                        pod=pod.idx))
            for u in range(N_UNITS):
                res.slice_busy_s[pod.offset + u] += block.makespan
            if tel is not None:
                tel.on_place(t0, pod.idx, grecs, ((0, N_UNITS),),
                             t0 + block.makespan, None, p.label, False)
            t0 += block.makespan
        leftover = [n for n, d in by_name.items() if d]
        assert not leftover, f"policy dropped submissions: {leftover}"
        res.busy_time += t0 - now
        res.dispatches += 1
        pod.busy = True
        push(t0, _FREE, (pod.idx, None))

    # --------------------------------------------- concurrent (slice) mode

    def _service(self, now, pod: _Pod, res, order, records, push) -> None:
        """Place one pod's dispatched groups onto its free slice units.

        Non-backfilled groups start strictly in dispatch order; a new
        window is formed once the dispatched queue has drained (FCFS across
        windows).  With backfill enabled, a *blocked* head additionally
        admits one lookahead window while idle units exist, so small later
        arrivals become backfill candidates — on full-pod-only traces no
        units are ever free while the head is blocked, which is what keeps
        this mode bit-compatible with blocking dispatch there."""
        while True:
            progress = False
            # FCFS: place the head while it fits
            while pod.ready:
                starts = find_offsets(pod.ready[0].partition, pod.free)
                if starts is None:
                    break
                self._place(now, pod, pod.ready.popleft(), starts, res, push)
                progress = True
            if pod.ready:
                if self.backfill:
                    # bounded EASY lookahead: at most one window past the
                    # blocked head's own window may be admitted early
                    if (pod.pending and any(pod.free)
                            and pod.ready[-1].window_id == pod.ready[0].window_id):
                        self._form_window(now, pod, res, order, records)
                        progress = True
                    if len(pod.ready) > 1:
                        progress |= self._backfill_scan(now, pod, res, push)
            elif pod.pending and any(pod.free):
                self._form_window(now, pod, res, order, records)
                progress = True
            if not progress:
                return

    def _dispatch_context(self, now, pod: _Pod, head, order,
                          free=None) -> DispatchContext:
        """Pod-state snapshot handed to the policy with each window: the
        live free-unit mask (the same list ``find_offsets`` places
        against — a narrow pod's missing upper units read busy), each head
        submission's age since arrival, and the depth of the pod's pending
        queue left behind — the arrival-aware observation an
        ``obs_context`` agent folds into its state."""
        return DispatchContext(
            free_units=tuple(pod.free) if free is None else free,
            ages_s=tuple(now - order[i].t for i in head),
            queue_depth=len(pod.pending),
            now_s=now)

    def _fit_to_pod(self, pl: Placement, pod: _Pod, res,
                    now: float = 0.0) -> list[Placement]:
        """Pod-width guard: a placement planned wider than the pod (the
        per-pod policy plans against the full partition table — e.g. an
        8-unit MPS pair routed onto a 4-unit pod) can never first-fit, so
        decompose it into right-sized solo placements.  Buddy packing of
        power-of-two slices totaling <= width always fits an empty pod,
        so ``total_units <= width`` is exact.  Router eligibility keeps
        each individual job's request within the pod, making the
        decomposition always placeable; ``SimResult.refits`` counts
        decompositions."""
        if pl.partition.total_units <= pod.width:
            return [pl]
        res.refits += 1
        if self.telemetry is not None:
            self.telemetry.on_refit(now, pod.idx, pl.partition.label,
                                    len(pl.group))
        return [Placement([j], solo_partition(min(j.requested_units,
                                                  pod.width)))
                for j in pl.group]

    def _form_window(self, now, pod: _Pod, res, order, records) -> None:
        head = [pod.pending.popleft()
                for _ in range(min(self.window, len(pod.pending)))]
        subs = [(order[i].binary, order[i].profile) for i in head]
        ctx = self._dispatch_context(now, pod, head, order)
        decision = self._decide(subs, ctx)
        by_name: dict[str, deque] = defaultdict(deque)
        for i in head:
            by_name[order[i].profile.name].append(records[i])
        for pl in decision.placements:
            for fitted in self._fit_to_pod(pl, pod, res, now):
                recs = [by_name[j.name].popleft() for j in fitted.group]
                pod.ready.append(_Run(fitted.group, fitted.partition, recs,
                                      corun(fitted.group, fitted.partition),
                                      window_id=res.dispatches))
        leftover = [n for n, d in by_name.items() if d]
        assert not leftover, f"policy dropped submissions: {leftover}"
        res.dispatches += 1
        if self.telemetry is not None:
            self.telemetry.on_window(now, pod.idx, head, len(pod.pending))

    def _backfill_scan(self, now, pod: _Pod, res, push) -> bool:
        """EASY backfill: later dispatched groups may start now iff they fit
        the idle units and predictably finish by the blocked head's reserved
        start.  Backfilled claims give their units back before the head's
        reservation, so the head can never be delayed."""
        t_res = self._earliest_fit(pod, pod.ready[0].partition)
        placed = False
        for run in list(pod.ready)[1:]:
            starts = find_offsets(run.partition, pod.free)
            if starts is None:
                continue
            if now + run.pred.makespan <= t_res + 1e-9:
                pod.ready.remove(run)
                self._place(now, pod, run, starts, res, push, backfilled=True)
                res.backfills += 1
                placed = True
        return placed

    def _earliest_fit(self, pod: _Pod, partition) -> float:
        """Earliest time `partition` fits the pod, replaying outstanding
        claim expiries (exact: no new non-backfill work is admitted past a
        blocked head, and backfill claims expire before this time)."""
        expiries = sorted({t1 for _, t1 in pod.claims.values()})
        free = list(pod.free)
        for t in expiries:
            for ranges, t1 in pod.claims.values():
                if t1 <= t:
                    for start, width in ranges:
                        free[start:start + width] = [True] * width
            if find_offsets(partition, free) is not None:
                return t
        return expiries[-1] if expiries else 0.0

    def _place(self, now, pod: _Pod, run: _Run, starts, res, push,
               backfilled: bool = False) -> None:
        ranges = tuple((st, s.units)
                       for st, s in zip(starts, run.partition.slices))
        width = 0
        for st, w in ranges:
            pod.free[st:st + w] = [False] * w
            width += w
        if pod.n_busy_units == 0:
            pod.busy_t0 = now
        pod.n_busy_units += width
        t1 = now + run.pred.makespan
        for rec, ft, (si, s, _b) in zip(run.recs, run.pred.finish_times,
                                        run.partition.slots):
            rec.dispatch = now
            rec.finish = now + ft
            rec.group_size = len(run.group)
            rec.partition = run.partition.label
            rec.units = s.units
            rec.backfilled = backfilled
        res.timeline.append(Segment(now, t1, len(run.group),
                                    run.partition.label, slices=ranges,
                                    backfilled=backfilled, pod=pod.idx))
        for st, w in ranges:
            for u in range(st, st + w):
                res.slice_busy_s[pod.offset + u] += run.pred.makespan
        cid = pod.cid
        pod.cid += 1
        pod.claims[cid] = (ranges, t1)
        push(t1, _FREE, (pod.idx, cid))
        if self.telemetry is not None:
            self.telemetry.on_place(now, pod.idx, run.recs, ranges, t1, cid,
                                    run.partition.label, backfilled)

    def _release(self, now, pod: _Pod, cid, res) -> None:
        ranges, _t1 = pod.claims.pop(cid)
        for st, w in ranges:
            pod.free[st:st + w] = [True] * w
            pod.n_busy_units -= w
        if pod.n_busy_units == 0:
            res.busy_time += now - pod.busy_t0
