"""Fleet telemetry: lifecycle tracing, streaming metrics, drift signals.
Port of ``repro/online/telemetry.py`` (pure Python, copied).

The simulator, router, retrain loop, and training scan are decision
systems built on *measurement* (the paper's profiles; MISO's continuous
runtime monitoring) — this module gives the serving stack the same
treatment.  Three layers, all optional and zero-cost when absent:

Lifecycle tracing
-----------------
:class:`TraceRecorder` collects structured events — every job's span
chain ``arrive → (route) → queue → window → place/backfill/refit → run →
free`` with pod/slice/claim attribution — and exports them two ways:

* **JSONL** (:meth:`TraceRecorder.write_jsonl`): one event dict per
  line, the raw stream for ad-hoc analysis.
* **Chrome trace JSON** (:meth:`TraceRecorder.write_chrome_trace`):
  ``trace_event``-format ``ph="X"`` complete events, one track per
  pod×slice (``pid`` = pod, ``tid`` = slice unit), loadable in Perfetto
  (https://ui.perfetto.dev) or ``chrome://tracing``.  Arrivals, window
  formations, refits, and ticks land on a per-pod "events" track as
  instants.

The event schema is documented in ``docs/observability.md``; the
span-chain invariants (every arrival placed exactly once, every claim
freed, no overlapping spans per slice) are pinned by
``tests/test_telemetry.py``.

Streaming metrics
-----------------
:class:`MetricsRegistry` holds :class:`Counter` / :class:`Gauge` /
:class:`Histogram` instruments — pure Python for the heap engine (the
reference's vectorized engine, not ported yet, accumulates the same
quantities in its ``MetricsState``).  Histograms use fixed bucket edges so
the heap and vectorized engines aggregate identically; ``WAIT_BUCKETS_S``
is the shared wait-time layout.  Registry aggregates match
``SimResult.summary()`` (counters exactly; float accumulations to
addition-order precision).

Drift signals
-------------
:class:`DriftMonitor` turns windowed observations (arrival class/width
mix entropy, live ``idle_slice_frac``) into a binary drift verdict
against EMA baselines — the drift-triggered retraining signal,
consumed by ``OnlineRetrainer(trigger="drift")``.  Per-interval
time-series come from ``SimResult.timeseries()`` (post-hoc, no recorder
needed).

:class:`PhaseTimer` is the small wall-clock helper behind
``benchmarks/online_sim.py --profile``.
"""
from __future__ import annotations

import bisect
import json
import math
import time
from dataclasses import dataclass, field

# Shared fixed wait-histogram bucket upper edges (seconds).  The heap's
# Histogram and the vectorized engine's MetricsState use the same edges,
# so their counts are directly comparable (len(edges)+1 buckets; the
# last bucket is the +inf overflow).
WAIT_BUCKETS_S: tuple[float, ...] = (
    1.0, 10.0, 60.0, 300.0, 1800.0, 7200.0, 28800.0)


def entropy_bits(counts) -> float:
    """Shannon entropy (bits) of a count distribution (dict or iterable)."""
    vals = list(counts.values()) if isinstance(counts, dict) else list(counts)
    total = float(sum(vals))
    if total <= 0:
        return 0.0
    h = 0.0
    for v in vals:
        if v > 0:
            p = v / total
            h -= p * math.log2(p)
    return h


# ---------------------------------------------------------------------------
# Metrics registry (heap-engine side; pure Python, stdlib only)
# ---------------------------------------------------------------------------


@dataclass
class Counter:
    """Monotonic accumulator (int or float increments)."""

    name: str
    value: float = 0.0

    def inc(self, n: float = 1) -> None:
        self.value += n


@dataclass
class Gauge:
    """Last-value instrument."""

    name: str
    value: float = 0.0

    def set(self, v: float) -> None:
        self.value = v


class Histogram:
    """Fixed-bucket histogram: ``len(edges)+1`` counts (last = overflow).

    ``edges`` are upper bucket edges: observation ``x`` lands in the
    first bucket with ``x <= edges[i]`` (``bisect_left``), matching the
    vectorized engine's ``searchsorted(..., side="left")``.
    """

    def __init__(self, name: str, edges: tuple[float, ...] = WAIT_BUCKETS_S):
        self.name = name
        self.edges = tuple(float(e) for e in edges)
        assert list(self.edges) == sorted(self.edges)
        self.counts = [0] * (len(self.edges) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, x: float) -> None:
        self.counts[bisect.bisect_left(self.edges, x)] += 1
        self.sum += x
        self.count += 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Bucket-interpolated percentile (uniform within a bucket).

        An approximation by construction — exact percentiles need the
        raw samples (``SimResult`` keeps those); tests bound the error
        against the numpy reference by one bucket width."""
        if not self.count:
            return 0.0
        target = q / 100.0 * self.count
        acc = 0
        for i, c in enumerate(self.counts):
            if acc + c >= target and c > 0:
                lo = 0.0 if i == 0 else self.edges[i - 1]
                hi = self.edges[i] if i < len(self.edges) else lo * 2 or 1.0
                return lo + (hi - lo) * (target - acc) / c
            acc += c
        return self.edges[-1]

    def to_dict(self) -> dict:
        return {"edges": list(self.edges), "counts": list(self.counts),
                "sum": self.sum, "count": self.count}


class MetricsRegistry:
    """Named instrument store with one-line-per-metric JSONL export."""

    def __init__(self):
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        return self._counters.setdefault(name, Counter(name))

    def gauge(self, name: str) -> Gauge:
        return self._gauges.setdefault(name, Gauge(name))

    def histogram(self, name: str,
                  edges: tuple[float, ...] = WAIT_BUCKETS_S) -> Histogram:
        if name not in self._histograms:
            self._histograms[name] = Histogram(name, edges)
        return self._histograms[name]

    def to_dicts(self) -> list[dict]:
        out = []
        for c in self._counters.values():
            out.append({"type": "counter", "name": c.name, "value": c.value})
        for g in self._gauges.values():
            out.append({"type": "gauge", "name": g.name, "value": g.value})
        for h in self._histograms.values():
            out.append({"type": "histogram", "name": h.name, **h.to_dict()})
        return sorted(out, key=lambda d: (d["type"], d["name"]))

    def write_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for d in self.to_dicts():
                f.write(json.dumps(d) + "\n")


# ---------------------------------------------------------------------------
# Lifecycle trace recorder
# ---------------------------------------------------------------------------


class TraceRecorder:
    """Append-only structured event stream with JSONL / Chrome export.

    Events read as plain dicts ``{"kind", "t_s", "pod", ...}`` via
    :attr:`events`; the simulator emits one at each lifecycle transition
    (see ``docs/observability.md`` for the per-kind payload schema).
    Internally the hot-path :meth:`emit` appends a compact
    ``(kind, t, pod, values)`` tuple and dict materialization is
    deferred until :attr:`events` is first read — recording must not tax
    the event loop (the ``telemetry_overhead`` gate).
    """

    #: positional payload schema for :meth:`emit`, per event kind.
    #: "place" is special-cased in :attr:`events` — its raw payload is
    #: ``(recs, slices, t1_s, claim, partition, backfilled)`` and the
    #: ``jobs``/``names`` columns come from the records at read time
    _FIELDS = {
        "arrive": ("job", "name", "job_class", "units"),
        "window": ("jobs", "pending_left"),
        "refit": ("partition", "n_jobs"),
        "free": ("claim",),
        "tick": (),
    }

    def __init__(self):
        self._raw: list[tuple] = []
        self._cache: list[dict] | None = None

    def emit(self, kind: str, t: float, pod: int, values: tuple = ()) -> None:
        """Hot-path append: ``values`` are positional per
        ``_FIELDS[kind]``; callers must pass payloads whose fields are
        immutable (or never mutated) since conversion happens at read
        time.  ``place`` payloads carry the group's ``JobRecord``\\ s —
        their ``idx``/``name``/``arrival`` are fixed at construction."""
        self._raw.append((kind, t, pod, values))

    def event(self, kind: str, t: float, pod: int = 0, **attrs) -> None:
        """Generic append for ad-hoc event kinds (builds the dict now)."""
        self._raw.append((kind, t, pod, attrs))

    @property
    def events(self) -> list[dict]:
        """The event stream as dicts (materialized lazily; the cache is
        rebuilt whenever the raw stream has grown)."""
        if self._cache is None or len(self._cache) != len(self._raw):
            fields = self._FIELDS
            ev = []
            for kind, t, pod, vals in self._raw:
                d = {"kind": kind, "t_s": t, "pod": pod}
                if type(vals) is dict:
                    d.update(vals)
                elif kind == "place":
                    recs, slices, t1, claim, partition, backfilled = vals
                    d["jobs"] = [r.idx for r in recs]
                    d["names"] = [r.name for r in recs]
                    # JSON-safe: slice ranges arrive as tuples
                    d["slices"] = [list(s) for s in slices]
                    d["t1_s"] = t1
                    d["claim"] = claim
                    d["partition"] = partition
                    d["backfilled"] = backfilled
                else:
                    d.update(zip(fields[kind], vals))
                ev.append(d)
            self._cache = ev
        return self._cache

    def __len__(self) -> int:
        return len(self._raw)

    def by_kind(self, kind: str) -> list[dict]:
        return [e for e in self.events if e["kind"] == kind]

    # ------------------------------------------------------------- spans

    def job_spans(self) -> dict[int, dict]:
        """Per-job lifecycle spans reconstructed from the event stream:
        ``{job_idx: {arrive, window, place, free, pod, backfilled}}``
        (missing stages stay ``None``).  The span-chain completeness
        tests assert every arrived job reaches ``place`` and its claim
        reaches ``free``."""
        spans: dict[int, dict] = {}
        claim_free: dict[tuple[int, int], float] = {}
        for e in self.events:
            if e["kind"] == "free" and e.get("claim") is not None:
                claim_free[(e["pod"], e["claim"])] = e["t_s"]
        for e in self.events:
            k = e["kind"]
            if k == "arrive":
                spans[e["job"]] = {"arrive": e["t_s"], "window": None,
                                   "place": None, "run_end": None,
                                   "free": None, "pod": e["pod"],
                                   "backfilled": False}
            elif k == "window":
                for j in e["jobs"]:
                    if j in spans:
                        spans[j]["window"] = e["t_s"]
            elif k == "place":
                for j in e["jobs"]:
                    if j in spans:
                        spans[j]["place"] = e["t_s"]
                        spans[j]["run_end"] = e["t1_s"]
                        spans[j]["backfilled"] = e.get("backfilled", False)
                        if e.get("claim") is not None:
                            spans[j]["free"] = claim_free.get(
                                (e["pod"], e["claim"]))
        return spans

    # ----------------------------------------------------------- exports

    def write_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for e in self.events:
                f.write(json.dumps(e) + "\n")

    def chrome_trace(self, pods: tuple[int, ...] = (8,)) -> dict:
        """``trace_event``-format dict: one process per pod, one thread
        per slice unit (plus an "events" thread per pod for instants).
        Each ``place`` event becomes one ``ph="X"`` complete event per
        claimed unit spanning ``[t_s, t1_s)`` — the slice-occupancy
        timeline as Perfetto tracks.  Timestamps are microseconds of
        simulated time."""
        te: list[dict] = []
        for p, w in enumerate(pods):
            te.append({"ph": "M", "pid": p, "tid": 0, "name": "process_name",
                       "args": {"name": f"pod{p} ({w} units)"}})
            for u in range(w):
                te.append({"ph": "M", "pid": p, "tid": u,
                           "name": "thread_name",
                           "args": {"name": f"unit {u}"}})
            te.append({"ph": "M", "pid": p, "tid": w, "name": "thread_name",
                       "args": {"name": "events"}})
        for e in self.events:
            p = e["pod"]
            ts = e["t_s"] * 1e6
            if e["kind"] == "place":
                dur = max(e["t1_s"] - e["t_s"], 0.0) * 1e6
                name = ",".join(e.get("names", [])) or e.get("partition", "run")
                for start, width in e["slices"]:
                    for u in range(start, start + width):
                        te.append({
                            "ph": "X", "pid": p, "tid": u, "ts": ts,
                            "dur": dur, "name": name,
                            "cat": ("backfill" if e.get("backfilled")
                                    else "run"),
                            "args": {"partition": e.get("partition", ""),
                                     "claim": e.get("claim"),
                                     "jobs": e.get("jobs", [])}})
            elif e["kind"] in ("arrive", "window", "refit", "tick"):
                tid = pods[p] if p < len(pods) else 0
                te.append({"ph": "i", "pid": p, "tid": tid, "ts": ts,
                           "s": "t", "name": e["kind"], "cat": "lifecycle",
                           "args": {k: v for k, v in e.items()
                                    if k not in ("kind", "t_s", "pod")}})
        return {"traceEvents": te, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path: str,
                           pods: tuple[int, ...] = (8,)) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(pods), f)


# ---------------------------------------------------------------------------
# The bundle the simulator consumes
# ---------------------------------------------------------------------------


class Telemetry:
    """Recorder + registry bundle with the simulator's emission hooks.

    Pass to ``ClusterSimulator(policy, cfg, telemetry=Telemetry())``.
    The hooks keep all metric semantics here so the simulator's hot path
    stays a handful of guarded one-line calls; with ``telemetry=None``
    (the default) the simulator pays one ``is not None`` test per event.

    Metric names (see ``docs/observability.md`` for units):

    * counters — ``jobs_arrived``, ``windows_formed``, ``groups_placed``,
      ``jobs_placed``, ``backfills``, ``refits``, ``frees``, ``ticks``,
      ``queue_depth_integral_s`` (∫ pending-depth dt),
      ``busy_unit_s`` (∫ claimed-units dt);
    * gauges — ``queue_depth``, ``busy_units`` (last event-time values);
    * histograms — ``wait_s`` (``WAIT_BUCKETS_S`` buckets).
    """

    def __init__(self, recorder: TraceRecorder | None = None,
                 metrics: MetricsRegistry | None = None):
        self.recorder = recorder if recorder is not None else TraceRecorder()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        m = self.metrics
        self._arrived = m.counter("jobs_arrived")
        self._windows = m.counter("windows_formed")
        self._groups = m.counter("groups_placed")
        self._jobs_placed = m.counter("jobs_placed")
        self._backfills = m.counter("backfills")
        self._refits = m.counter("refits")
        self._frees = m.counter("frees")
        self._ticks = m.counter("ticks")
        self._qd_int = m.counter("queue_depth_integral_s")
        self._busy_int = m.counter("busy_unit_s")
        self._qd = m.gauge("queue_depth")
        self._busy = m.gauge("busy_units")
        self._wait = m.histogram("wait_s", WAIT_BUCKETS_S)
        # bound raw-stream append: the hooks run per simulator event, so
        # they skip the emit() call layer (the events property detects
        # growth by length, no invalidation needed)
        self._append = self.recorder._raw.append

    # ------------------------------------------------------------- hooks

    def on_clock(self, dt: float, queue_depth: int, busy_units: int) -> None:
        """Advance the time integrals over an elapsed event gap ``dt``
        during which ``queue_depth``/``busy_units`` were constant."""
        self._qd_int.value += queue_depth * dt
        self._busy_int.value += busy_units * dt
        self._qd.value = queue_depth
        self._busy.value = busy_units

    def on_clock_totals(self, qd_integral_s: float, busy_integral_s: float,
                        queue_depth: int, busy_units: int) -> None:
        """Fold whole-run integral totals in one call.  The simulator
        accumulates the event-gap integrals in loop locals (a per-pop
        hook call is measurable against the ``telemetry_overhead`` gate)
        and flushes them here when the heap drains; the gauges get the
        last event-time values."""
        self._qd_int.value += qd_integral_s
        self._busy_int.value += busy_integral_s
        self._qd.value = queue_depth
        self._busy.value = busy_units

    def on_arrive(self, t: float, pod: int, job: int, name: str,
                  job_class: str, units: int) -> None:
        self._arrived.value += 1
        self._append(("arrive", t, pod, (job, name, job_class, units)))

    def on_window(self, t: float, pod: int, jobs: list[int],
                  pending_left: int) -> None:
        self._windows.value += 1
        self._append(("window", t, pod, (jobs, pending_left)))

    def on_place(self, t: float, pod: int, recs, slices, t1: float,
                 claim, partition: str, backfilled: bool) -> None:
        """``recs`` are the placed group's ``JobRecord``\\ s — their
        ``idx``/``name`` columns materialize lazily with the event."""
        self._groups.value += 1
        self._jobs_placed.value += len(recs)
        if backfilled:
            self._backfills.value += 1
        observe = self._wait.observe
        for r in recs:
            observe(t - r.arrival)
        self._append(("place", t, pod,
                      (recs, slices, t1, claim, partition, backfilled)))

    def on_refit(self, t: float, pod: int, partition: str,
                 n_jobs: int) -> None:
        self._refits.value += 1
        self._append(("refit", t, pod, (partition, n_jobs)))

    def on_free(self, t: float, pod: int, claim) -> None:
        self._frees.value += 1
        self._append(("free", t, pod, (claim,)))

    def on_tick(self, t: float) -> None:
        self._ticks.value += 1
        self._append(("tick", t, 0, ()))


# ---------------------------------------------------------------------------
# Drift signals
# ---------------------------------------------------------------------------


@dataclass
class DriftMonitor:
    """EMA-baseline drift detector over arrival-mix and occupancy signals.

    Each :meth:`observe` call supplies one window's measurements:

    * ``class_counts`` — arrival counts per job class (CI/MI/US) since
      the last observation;
    * ``width_counts`` — arrival counts per requested slice width;
    * ``idle_slice_frac`` — the live idle-slice-time fraction.

    The monitor compares each window's class/width mix **entropy**
    (bits) and idle fraction against exponential-moving-average
    baselines; drift fires when the entropy shifts by more than
    ``entropy_threshold`` bits or the idle fraction *rises* more than
    ``idle_threshold`` above its baseline (occupancy collapsing — the
    serving agent has gone stale).  The first observation only seeds the
    baselines.  After a consumer acts on a drift verdict (e.g. a
    retraining cycle) call :meth:`rebase` so the post-action regime
    becomes the new baseline instead of re-firing every window.
    """

    entropy_threshold: float = 0.5       # bits of mix-entropy shift
    idle_threshold: float = 0.15         # idle_slice_frac rise
    alpha: float = 0.5                   # EMA smoothing
    min_arrivals: int = 4                # windows thinner than this only
                                         # update the EMA, never fire
    history: list = field(default_factory=list)

    def __post_init__(self):
        self._ema: dict[str, float] | None = None
        self._pending_rebase = False

    def observe(self, class_counts: dict, width_counts: dict,
                idle_slice_frac: float) -> dict:
        """Fold one window in; returns ``{"drift": bool, "signals": {...},
        "reasons": [...]}`` (also appended to ``history``)."""
        n = sum(class_counts.values())
        sig = {"class_entropy": entropy_bits(class_counts),
               "width_entropy": entropy_bits(width_counts),
               "idle_slice_frac": float(idle_slice_frac),
               "arrivals": int(n)}
        reasons: list[str] = []
        if self._ema is None or self._pending_rebase:
            self._ema = {k: sig[k] for k in
                         ("class_entropy", "width_entropy",
                          "idle_slice_frac")}
            self._pending_rebase = False
        elif n >= self.min_arrivals:
            if abs(sig["class_entropy"] - self._ema["class_entropy"]) \
                    > self.entropy_threshold:
                reasons.append("class_entropy")
            if abs(sig["width_entropy"] - self._ema["width_entropy"]) \
                    > self.entropy_threshold:
                reasons.append("width_entropy")
            if sig["idle_slice_frac"] - self._ema["idle_slice_frac"] \
                    > self.idle_threshold:
                reasons.append("idle_slice_frac")
        a = self.alpha
        for k in ("class_entropy", "width_entropy", "idle_slice_frac"):
            self._ema[k] = a * sig[k] + (1 - a) * self._ema[k]
        out = {"drift": bool(reasons), "signals": sig, "reasons": reasons}
        self.history.append(out)
        return out

    def rebase(self) -> None:
        """Reset the EMA baselines at the next observation (call after a
        retraining cycle: the refreshed agent defines the new normal)."""
        self._pending_rebase = True


# ---------------------------------------------------------------------------
# Wall-clock phase profiling (benchmarks --profile)
# ---------------------------------------------------------------------------


class PhaseTimer:
    """Accumulate wall time per named phase; ``as_dict`` is JSON-able."""

    def __init__(self):
        self.totals: dict[str, float] = {}

    class _Span:
        def __init__(self, timer, name):
            self.timer, self.name = timer, name

        def __enter__(self):
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self.timer.totals[self.name] = (
                self.timer.totals.get(self.name, 0.0)
                + time.perf_counter() - self.t0)
            return False

    def phase(self, name: str) -> "PhaseTimer._Span":
        return PhaseTimer._Span(self, name)

    def add(self, name: str, seconds: float) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + seconds

    def as_dict(self) -> dict[str, float]:
        return {k: round(v, 6) for k, v in sorted(self.totals.items())}
