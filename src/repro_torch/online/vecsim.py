"""Vectorized cluster simulator: the event heap as batched tensor lanes.

Port of ``repro/online/vecsim.py``.  The reference runs one trace as a flat
``lax.while_loop`` of predicated micro-actions and a batch of traces under
``vmap``; here the state is a NamedTuple of tensors with a **leading batch
axis B** (one lane per trace, per pod, or per agent x trace) and the loop
runs on the host:

* Every update is a fixed-shape tensor operation over all B lanes.  Each
  iteration computes the reference's body for every lane and then keeps it
  only where the lane is alive (``live(st) & (st.err == 0)``): a finished
  lane's clock, counters, error lane and metrics never change again, as
  ``vmap`` freezes a finished lane of a batched ``while_loop``.
* The host reads ``alive.any()`` once every ``_SYNC_EVERY`` (8) iterations;
  the iterations in between are exact no-ops for dead lanes.  On the card
  those 8 iterations (some 300 small kernels each) replay from one CUDA
  graph (:class:`_Steps`): launched one by one they leave the card idle
  most of the time.
* The reference's ``mode="drop"`` scatters (a masked-off write aimed at an
  out-of-range row) become writes into one spare row that is sliced off
  (:func:`_put`), so no index ever leaves its buffer.  Argmin and argmax
  over masks cast to an integer type and take the first index on ties, as
  ``jnp.argmin``/``jnp.argmax`` do.

Event-table layout (the heap, flattened)
----------------------------------------
* **ARRIVE** — the sorted trace is the event table: ``pend_lo``..``pend_hi``
  index the admitted-but-undispatched span, the next arrival is
  ``t[pend_hi]``.
* **FREE** — outstanding slice claims live in ``N_UNITS`` fixed slots
  (expiry, claimed-unit mask, active flag); the next free event is the
  masked min over expiries.
* **TICK** — not represented: re-training is a host callback, so the heap
  simulator stays the only path with ``on_tick``.

One event step takes ``now = min(next arrival, next expiry)``, drains every
event with ``t <= now``, then runs the heap's service fixpoint one
micro-action an iteration: place the FCFS head while it first-fits, admit
one bounded lookahead window past a blocked head, EASY-backfill later groups
that finish before the head's earliest feasible start, form a window onto an
idle pod.

The RL engine (``_build_run_rl``) nests a service loop inside a window loop
in the reference: the service body runs until the lane *wants* a window
formed, then ``form_and_plan`` runs the agent's greedy co-scheduling episode
at that seam.  A lane's decisions do not depend on lockstep (the training
draws are indexed by window id and episode step), so here the service body
runs on the lanes that do not want a formation, and ``form_and_plan`` runs,
predicated on ``want``, whenever some lane wants one.

Parity: the same decisions as the heap simulator
(:class:`~repro_torch.online.simulator.ClusterSimulator`) — placement order,
groups, partitions, slice ranges, backfill and refit outcomes — with times
to f32 resolution of the clock.  Solo durations come from the f64 model cast
to f32 once; only true co-run groups take the f32 batched model
(:func:`~repro_torch.core.perfmodel_vec.group_metrics`).  A trace longer than
``capacity`` raises ``ValueError`` before any device work; the error lanes
(ready-ring and event-step overflow, an episode that does not end) raise
``RuntimeError`` — nothing is truncated quietly.

The engine's device work is batched torch code (no hand-written kernel):
entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``.  ``sweep(devices=...)`` is the reference's ``pmap`` over
devices: a list of one device, or of a count that does not divide the
batch, runs the unsharded sweep as the reference does; torch's form of
``pmap`` is one process a card, so the batch is sharded over a 1-D
``DeviceMesh`` whose every rank calls ``sweep`` (:meth:`VectorizedClusterSimulator.sweep`).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core.network import greedy_q_action
from repro_torch.core.partition import (
    N_UNITS, Partition, Slice, enumerate_partitions, slice_label, solo_partition,
)
from repro_torch.core.perfmodel import corun
from repro_torch.core.perfmodel_vec import (
    UNIT_SIZES, GraphedGroupMetrics, JobTermsTable, QueueArrays, build_partition_table,
    group_metrics, job_terms_table, solo_duration_table,
)
from repro_torch.online.policies import RLDispatchPolicy, TimeSharingPolicy
from repro_torch.online.router import FleetView, PodView, make_router
from repro_torch.online.simulator import Arrival, JobRecord, Segment, SimConfig, SimResult
from repro_torch.online.telemetry import WAIT_BUCKETS_S

_BIG_SEQ = 2 ** 30
_SYNC_EVERY = 8                 # iterations between host reads of alive.any()

# constant aligned-buddy fit tensors, indexed by width index into
# UNIT_SIZES: _COVERED[u, s, :] = units a width-u slice at offset s spans;
# _ALIGNED[u, s] = offset s is buddy-aligned and in range
_COVERED = torch.as_tensor(np.stack([
    (np.arange(N_UNITS)[None, :] >= np.arange(N_UNITS)[:, None])
    & (np.arange(N_UNITS)[None, :] < np.arange(N_UNITS)[:, None] + w)
    for w in UNIT_SIZES]))                    # (U, 8, 8) bool
_ALIGNED = torch.as_tensor(np.stack([
    (np.arange(N_UNITS) % w == 0) & (np.arange(N_UNITS) + w <= N_UNITS)
    for w in UNIT_SIZES]))                    # (U, 8) bool

# error lanes (bitwise-OR'd): the wrapper raises RuntimeError on any
ERR_READY_OVERFLOW = 1          # ready ring out of slots (eager guard)
ERR_EVENT_OVERFLOW = 2          # more than 2*capacity+4 event steps
ERR_EPISODE = 4                 # an RL co-schedule episode did not end


class _Consts(NamedTuple):
    covered: torch.Tensor        # (U, 8, 8) bool
    aligned: torch.Tensor        # (U, 8) bool
    unit_idx: torch.Tensor       # (8,) int64
    units: torch.Tensor          # (U,) int64 — UNIT_SIZES
    wait_edges: torch.Tensor     # (len(WAIT_BUCKETS_S),) f32


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device) -> _Consts:
    return _Consts(covered=_COVERED.to(device), aligned=_ALIGNED.to(device),
                   unit_idx=torch.arange(N_UNITS, device=device),
                   units=torch.tensor(UNIT_SIZES, dtype=torch.int64, device=device),
                   wait_edges=torch.tensor(np.array(WAIT_BUCKETS_S, np.float32),
                                           device=device))


class TraceArrays(NamedTuple):
    """Compiled traces: sorted arrival lanes, padded to ``capacity``
    (one trace from :func:`compile_trace`, a leading batch axis once
    stacked by :func:`stack_traces`)."""

    t: torch.Tensor              # (A,) f32 — sorted arrival times (+inf padding)
    job: torch.Tensor            # (A,) int64 — row into the job table
    n: torch.Tensor              # () int64 — live arrivals (rest padding)


class JobTable(NamedTuple):
    """Distinct-job lanes shared by every trace of a sweep."""

    width: torch.Tensor          # (J,) int64 — requested slice width (units)
    widx: torch.Tensor           # (J,) int64 — index into UNIT_SIZES
    dur: torch.Tensor            # (J,) f32 — solo makespan at that width (f64, cast once)
    solo8: torch.Tensor          # (J,) f32 — full-pod solo time (throughput)


class _State(NamedTuple):
    """The whole simulation as fixed-shape lanes (leading B; A = capacity,
    R = ready ring)."""

    now: torch.Tensor            # (B,) f32
    pend_lo: torch.Tensor        # (B,) — first undispatched admitted arrival
    pend_hi: torch.Tensor        # (B,) — first un-admitted arrival
    profiled: torch.Tensor       # (B, J) bool — repository bitmap (first sight)
    free: torch.Tensor           # (B, N_UNITS) bool — idle slice units
    r_active: torch.Tensor       # (B, R) bool — ready ring
    r_seq: torch.Tensor          # (B, R) — global FCFS order
    r_win: torch.Tensor          # (B, R) — dispatch window id
    r_grp: torch.Tensor          # (B, R) — row into the group log
    next_seq: torch.Tensor       # (B,)
    c_active: torch.Tensor       # (B, N_UNITS) bool — claim table
    c_t1: torch.Tensor           # (B, N_UNITS) f32 — expiry
    c_mask: torch.Tensor         # (B, N_UNITS, N_UNITS) bool — claimed units
    n_busy: torch.Tensor         # (B,)
    busy_t0: torch.Tensor        # (B,) f32
    busy_time: torch.Tensor      # (B,) f32
    slice_busy: torch.Tensor     # (B, N_UNITS) f32
    dispatches: torch.Tensor     # (B,)
    backfills: torch.Tensor      # (B,)
    n_groups: torch.Tensor       # (B,)
    place_seq: torch.Tensor      # (B,) — placement order (timeline)
    steps: torch.Tensor          # (B,) — event steps retired
    err: torch.Tensor            # (B,) — ERR_* lanes
    g_arr: torch.Tensor          # (B, A) — arrival index (A = unused)
    g_job: torch.Tensor          # (B, A) — row into the job table
    g_t0: torch.Tensor           # (B, A) f32 — placement time
    g_pack: torch.Tensor         # (B, A) — (pseq << 4) | (start << 1) | backfilled


class MetricsState(NamedTuple):
    """Streaming metrics accumulated in the loop when an engine is built with
    ``telemetry=True`` — the mirror of the heap's
    :class:`~repro_torch.online.telemetry.Telemetry` aggregates (the same
    ``WAIT_BUCKETS_S`` histogram, the same event-gap integrals), one lane
    per trace."""

    wait_hist: torch.Tensor      # (B, len(WAIT_BUCKETS_S)+1) counts
    wait_sum: torch.Tensor       # (B,) f32 — Σ wait at placement
    queue_depth_int: torch.Tensor  # (B,) f32 — ∫ pending depth dt
    busy_unit_int: torch.Tensor  # (B,) f32 — ∫ claimed units dt
    places: torch.Tensor         # (B,) — groups placed


def _metrics_init(B: int, device) -> MetricsState:
    return MetricsState(
        wait_hist=torch.zeros((B, len(WAIT_BUCKETS_S) + 1), dtype=torch.int64, device=device),
        wait_sum=torch.zeros(B, device=device), queue_depth_int=torch.zeros(B, device=device),
        busy_unit_int=torch.zeros(B, device=device),
        places=torch.zeros(B, dtype=torch.int64, device=device))


class SweepSummary(NamedTuple):
    """Per-trace metrics of a batched sweep (leading batch axis)."""

    makespan: torch.Tensor
    throughput: torch.Tensor
    mean_wait: torch.Tensor
    p50_wait: torch.Tensor
    p99_wait: torch.Tensor
    mean_turnaround: torch.Tensor
    p95_turnaround: torch.Tensor
    utilization: torch.Tensor
    slice_utilization: torch.Tensor
    backfills: torch.Tensor
    dispatches: torch.Tensor
    err: torch.Tensor


# --------------------------------------------------------------- primitives

def _bidx(idx: torch.Tensor) -> torch.Tensor:
    """Lane indices broadcast against ``idx`` (leading axis B)."""
    B = idx.shape[0]
    return torch.arange(B, device=idx.device).view(B, *([1] * (idx.dim() - 1)))


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-lane gather along axis 1: ``x`` (B, N, ...), ``idx`` (B, ...) ->
    (B, ..., *x.shape[2:])."""
    return x[_bidx(idx), idx]


def _put(x: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """A copy of ``x`` (B, N, ...) with rows ``idx`` (B, ...) of axis 1 set to
    ``val``; an index of N or more writes a spare row that is dropped (the
    reference's ``.at[].set(mode="drop")``).  Rows below N are unique."""
    N = x.shape[1]
    idx = idx.clamp_max(N)
    if not torch.is_tensor(val):      # made on the device: no host copy in a graph
        val = torch.full((), val, dtype=x.dtype, device=x.device)
    pad = torch.cat([x, x[:, :1]], dim=1)
    pad[_bidx(idx), idx] = val.to(x.dtype)
    return pad[:, :N]


def _add(x: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """:func:`_put` with ``.at[].add`` semantics (repeated rows accumulate),
    for ``x`` (B, N)."""
    B, N = x.shape
    idx = idx.clamp_max(N).reshape(B, -1)
    pad = torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)
    pad.scatter_add_(1, idx, val.reshape(B, -1).to(x.dtype))
    return pad[:, :N]


def _first_true(mask: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of the first True along ``dim`` (0 when none), as ``jnp.argmax``."""
    return torch.argmax(mask.to(torch.int32), dim=dim)


def _select(pred: torch.Tensor, new, old):
    """Field-wise ``where(pred, new, old)`` over a NamedTuple of lanes."""
    def sel(n, o):
        return torch.where(pred.view(-1, *([1] * (o.dim() - 1))), n, o)
    return type(old)(*(sel(n, o) for n, o in zip(new, old)))


def _fit_table(free: torch.Tensor) -> torch.Tensor:
    """Per-width first-fit table on ``free`` (B, 8): ``(B, U, 8)`` bool —
    offset s is buddy-aligned for width ``UNIT_SIZES[u]`` and every unit
    it covers is idle.  First fit = the first True."""
    k = _consts(free.device)
    return k.aligned[None] & (free[:, None, None, :] | ~k.covered[None]).all(dim=3)


def _claim_units(start: torch.Tensor, width: torch.Tensor) -> torch.Tensor:
    u = _consts(start.device).unit_idx
    return (u >= start[..., None]) & (u < (start + width)[..., None])


def _head(st):
    """FCFS head of the ready ring: min seq among active slots."""
    seqs = torch.where(st.r_active, st.r_seq, _BIG_SEQ)
    return torch.argmin(seqs, dim=1), st.r_active.any(dim=1)


def _percentile(x: torch.Tensor, valid: torch.Tensor, q: float) -> torch.Tensor:
    """Masked ``np.percentile(x[valid], q)`` per lane (linear interpolation)."""
    n = valid.sum(dim=1)
    s = torch.sort(torch.where(valid, x, torch.inf), dim=1).values
    nm1 = (n - 1).clamp_min(0)
    pos = torch.tensor(q / 100.0, dtype=torch.float32) * nm1.to(torch.float32)
    lo = torch.floor(pos).to(torch.int64)
    hi = torch.minimum(lo + 1, nm1)
    frac = pos - lo.to(torch.float32)
    lo = lo.clamp(0, x.shape[1] - 1)
    hi = hi.clamp(0, x.shape[1] - 1)
    out = _take(s, lo) * (1.0 - frac) + _take(s, hi) * frac
    return torch.where(n > 0, out, 0.0)


def _live(st, trace: TraceArrays) -> torch.Tensor:
    return ((st.pend_hi < trace.n) | st.c_active.any(dim=1)
            | (st.pend_lo < st.pend_hi) | st.r_active.any(dim=1))


def _advance(st, trace: TraceArrays, adv: torch.Tensor, max_steps: int, ms=None):
    """No service progress on lanes ``adv``: advance the clock to the next
    event and drain everything coincident with it (every arrival with
    ``t <= now`` admitted, every claim with ``t1 <= now`` released).  The
    trace is sorted, so the new cursor is the count of ``t <= now``
    (padding is +inf and never admits).  Returns (state, metrics)."""
    A = trace.t.shape[1]
    t_arr = torch.where(st.pend_hi < trace.n,
                        _take(trace.t, st.pend_hi.clamp(0, A - 1)), torch.inf)
    t_free = torch.where(st.c_active, st.c_t1, torch.inf).amin(dim=1)
    now = torch.where(adv, torch.minimum(t_arr, t_free), st.now)
    pend_hi = torch.where(adv, (trace.t <= now[:, None]).sum(dim=1), st.pend_hi)
    rel = adv[:, None] & st.c_active & (st.c_t1 <= now[:, None])
    relm = rel[:, :, None] & st.c_mask
    freed = relm.any(dim=1)
    w_rel = relm.sum(dim=(1, 2))
    n_busy = st.n_busy - w_rel
    busy_time = st.busy_time + torch.where((n_busy == 0) & (w_rel > 0),
                                           now - st.busy_t0, 0.0)
    steps = st.steps + adv.to(torch.int64)
    if ms is not None:
        # event-gap integrals: depth and busy units are constant over [st.now, now)
        dt = now - st.now
        ms = ms._replace(
            queue_depth_int=ms.queue_depth_int
            + (st.pend_hi - st.pend_lo).to(torch.float32) * dt,
            busy_unit_int=ms.busy_unit_int + st.n_busy.to(torch.float32) * dt)
    st = st._replace(
        now=now, pend_hi=pend_hi, free=st.free | freed, c_active=st.c_active & ~rel,
        n_busy=n_busy, busy_time=busy_time, steps=steps,
        err=st.err | torch.where(steps > max_steps, ERR_EVENT_OVERFLOW, 0))
    return st, ms


def _wait_bucket(wait: torch.Tensor) -> torch.Tensor:
    """``searchsorted(WAIT_BUCKETS_S, wait, side="left")`` over f32 edges."""
    return torch.searchsorted(_consts(wait.device).wait_edges, wait.contiguous(), right=False)


class _Steps:
    """``n`` iterations of a host loop's body on a flat tuple of state
    tensors, then the flags the host reads before the next ``n``.

    On the card the ``n`` iterations (some 300 small kernels each) are
    captured once into a CUDA graph and replayed, one host call for what
    the eager loop launches one kernel at a time; on the CPU they run
    eagerly.  ``step(state) -> state`` and ``flags(state) -> (k,) bool`` are
    fixed-shape tensor code that reads nothing back to the host and writes
    none of its inputs."""

    def __init__(self, step, flags, state: tuple, n: int):
        self._step, self._flags, self._n = step, flags, n
        self.state = tuple(state)
        self._graph = None
        if self.state[0].device.type != "cuda":
            return
        self.state = tuple(x.clone() for x in state)
        cur = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):                 # warm-up off the capture
            self._run(self.state)
        cur.wait_stream(side)
        self._graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self._graph):
            out, self._flag_out = self._run(self.state)
            for dst, src in zip(self.state, out):
                dst.copy_(src)

    def _run(self, state):
        for _ in range(self._n):
            state = self._step(state)
        return state, self._flags(state)

    def advance(self) -> list[bool]:
        """Run the next ``n`` iterations; returns the flags after them."""
        if self._graph is None:
            self.state, flags = self._run(self.state)
            return flags.tolist()
        self._graph.replay()
        return self._flag_out.tolist()

    def set(self, state: tuple) -> None:
        """Replace the state between two ``advance`` calls."""
        if self._graph is None:
            self.state = tuple(state)
        else:
            for dst, src in zip(self.state, state):
                dst.copy_(src)


def _iteration_limit(capacity: int) -> int:
    """Iterations any lane can need, rounded up by a sync interval: each
    one places a group (at most one a job), forms a window (each pops at
    least one job) or retires an event step (at most 2*capacity+5 before
    the error lane stops the lane)."""
    return 4 * capacity + 16 + _SYNC_EVERY


# ------------------------------------------------------------ state updates
#
# Every update below is predicated on a ``do`` flag (B,), as in the
# reference: a masked-off write goes to a dropped spare row.

def _place(st: _State, jobs: JobTable, slot, start, backfilled, do) -> _State:
    """Claim the first-fit range for ready slot ``slot`` (heap ``_place``),
    on lanes ``do``."""
    g = _take(st.r_grp, slot)
    j = _take(st.g_job, g)
    w = jobs.width[j]
    dur = jobs.dur[j]
    mask = _claim_units(start, w) & do[:, None]
    doi = do.to(torch.int64)
    A, R = st.g_arr.shape[1], st.r_active.shape[1]
    gt = torch.where(do, g, A)
    ct = torch.where(do, torch.argmin(st.c_active.to(torch.int32), dim=1), N_UNITS)
    rt = torch.where(do, slot, R)
    pack = (st.place_seq << 4) | (start << 1) | backfilled.to(torch.int64)
    return st._replace(
        free=st.free & ~mask,
        busy_t0=torch.where(do & (st.n_busy == 0), st.now, st.busy_t0),
        n_busy=st.n_busy + doi * w,
        c_active=_put(st.c_active, ct, True),
        c_t1=_put(st.c_t1, ct, st.now + dur),
        c_mask=_put(st.c_mask, ct, mask),
        slice_busy=st.slice_busy + torch.where(mask, dur[:, None], 0.0),
        g_t0=_put(st.g_t0, gt, st.now),
        g_pack=_put(st.g_pack, gt, pack),
        place_seq=st.place_seq + doi,
        r_active=_put(st.r_active, rt, False),
        backfills=st.backfills + (do & backfilled).to(torch.int64))


def _expiry_free_maps(st) -> torch.Tensor:
    """(B, 8, 8): row i is the unit availability once every claim expiring
    by ``c_t1[:, i]`` has released — the candidates of an earliest fit."""
    rel = (st.c_active[:, None, :] & st.c_active[:, :, None]
           & (st.c_t1[:, None, :] <= st.c_t1[:, :, None]))
    return st.free[:, None, :] | (rel[..., None] & st.c_mask[:, None]).any(dim=2)


def _earliest_time(st, fits: torch.Tensor) -> torch.Tensor:
    """The earliest claim expiry whose free map fits (``fits`` (B, 8) over
    :func:`_expiry_free_maps`' rows): availability at a time depends only
    on which claims expired by it, so no sort is needed.  With no fit, the
    last expiry; with no claim, 0."""
    fits = st.c_active & fits
    first = torch.where(fits, st.c_t1, torch.inf).amin(dim=1)
    last = torch.where(st.c_active, st.c_t1, -torch.inf).amax(dim=1)
    return torch.where(fits.any(dim=1), first,
                       torch.where(st.c_active.any(dim=1), last, 0.0))


def _earliest_fit(st: _State, widx: torch.Tensor) -> torch.Tensor:
    """Earliest time a width-``UNIT_SIZES[widx]`` slice fits, replaying claim
    expiries (the heap's ``_earliest_fit`` reservation)."""
    k = _consts(st.free.device)
    freed = _expiry_free_maps(st)
    cov, ali = k.covered[widx], k.aligned[widx]           # (B, 8, 8), (B, 8)
    return _earliest_time(st, (ali[:, None, :]
                               & (freed[:, :, None, :] | ~cov[:, None]).all(dim=3)).any(dim=2))


def _make_form_window(trace: TraceArrays, jobs: JobTable, window: int):
    """The window-formation step (the plan seam): pop <= ``window`` pending
    submissions, run the first-sight protocol over the profiled bitmap, and
    materialize the solo plan — first-sight groups ahead of the planned
    remainder, both in submission order."""
    A = trace.t.shape[1]
    i_w = torch.arange(window, device=trace.t.device)

    def form_window(st: _State, do) -> _State:
        J = st.profiled.shape[1]
        k = torch.where(do, torch.clamp_max(st.pend_hi - st.pend_lo, window), 0)
        on = i_w[None] < k[:, None]
        arr = (st.pend_lo[:, None] + i_w).clamp(0, A - 1)
        jrow = _take(trace.job, arr)
        # a submission profiles iff its binary is new to the repository AND
        # it is the first occurrence inside this window
        earlier_same = ((jrow[:, None, :] == jrow[:, :, None])
                        & (i_w[None, :] < i_w[:, None]) & on[:, None, :])
        fs = on & ~earlier_same.any(dim=2) & ~_take(st.profiled, jrow)
        profiled = _put(st.profiled, torch.where(on, jrow, J), True)
        # placement order: first-sight solos first, then the planned
        # remainder — each in submission order
        n_fs = fs.sum(dim=1)
        rank_fs = fs.cumsum(dim=1) - 1
        rank_pl = (~fs & on).cumsum(dim=1) - 1
        pos = torch.where(fs, rank_fs, n_fs[:, None] + rank_pl)
        grow = torch.where(on, st.n_groups[:, None] + pos, A)
        # group q claims the q-th inactive ring slot in index order
        free_rank = (~st.r_active).cumsum(dim=1) - 1
        q = torch.where(~st.r_active & (free_rank < k[:, None]), free_rank, -1)
        sel = q >= 0
        err = st.err | torch.where((~st.r_active).sum(dim=1) < k, ERR_READY_OVERFLOW, 0)
        return st._replace(
            profiled=profiled,
            g_arr=_put(st.g_arr, grow, arr), g_job=_put(st.g_job, grow, jrow),
            r_active=st.r_active | sel,
            r_seq=torch.where(sel, st.next_seq[:, None] + q, st.r_seq),
            r_win=torch.where(sel, st.dispatches[:, None], st.r_win),
            r_grp=torch.where(sel, st.n_groups[:, None] + q, st.r_grp),
            err=err, next_seq=st.next_seq + k, n_groups=st.n_groups + k,
            pend_lo=st.pend_lo + k, dispatches=st.dispatches + do.to(torch.int64))

    return form_window


# -------------------------------------------------------------- trace runs

def _build_run(window: int, backfill: bool, capacity: int, telemetry: bool = False):
    """The time-sharing engine: ``run(trace, jobs, width)`` over a batch of
    traces (``width`` (B,): each lane's pod width; a narrower pod is the
    same engine with its upper units born busy).

    Each iteration performs exactly one micro-action of the heap's
    event/service interleaving per lane — place the FCFS head if it fits,
    else (blocked head) admit the bounded EASY lookahead window, place the
    lowest-seq eligible backfill candidate, form a window onto an idle pod,
    or advance the clock.  One-candidate-per-iteration backfill is the
    heap's multi-placement scan: a backfilled claim expires by ``t_res``
    and occupies units free when the scan started, so the replayed
    ``t_res`` is unchanged and re-scanning from the lowest seq makes the
    same placements.

    ``telemetry=True`` threads a :class:`MetricsState` alongside (``run``
    then returns ``(state, metrics)``); the ``_State`` trajectory is the
    same with it on or off.  ``run.stats`` holds the last call's lane,
    iteration and formation counts.
    """
    max_steps = 2 * capacity + 4

    def run(trace: TraceArrays, jobs: JobTable, width: torch.Tensor):
        dev = trace.t.device
        B, A = trace.t.shape
        assert A == capacity, (A, capacity)
        R = 2 * window + 2
        J = jobs.width.shape[0]
        f32, i64 = torch.float32, torch.int64
        form_window = _make_form_window(trace, jobs, window)
        r_rng = torch.arange(R, device=dev)

        def z(*shape, dtype=i64):
            return torch.zeros((B, *shape), dtype=dtype, device=dev)

        st = _State(
            now=z(dtype=f32), pend_lo=z(), pend_hi=z(), profiled=z(J, dtype=torch.bool),
            free=_consts(dev).unit_idx[None] < width[:, None],
            r_active=z(R, dtype=torch.bool), r_seq=z(R), r_win=z(R), r_grp=z(R),
            next_seq=z(), c_active=z(N_UNITS, dtype=torch.bool), c_t1=z(N_UNITS, dtype=f32),
            c_mask=z(N_UNITS, N_UNITS, dtype=torch.bool), n_busy=z(), busy_t0=z(dtype=f32),
            busy_time=z(dtype=f32), slice_busy=z(N_UNITS, dtype=f32), dispatches=z(),
            backfills=z(), n_groups=z(), place_seq=z(), steps=z(), err=z(),
            g_arr=torch.full((B, A), A, dtype=i64, device=dev), g_job=z(A),
            g_t0=z(A, dtype=f32), g_pack=z(A))
        ms = _metrics_init(B, dev) if telemetry else None

        def body(st: _State, ms):
            # --- rule 1: place the FCFS head if it first-fits
            head, head_exists = _head(st)
            hwidx = jobs.widx[_take(st.g_job, _take(st.r_grp, head))]
            ftab = _fit_table(st.free)
            fh = _take(ftab, hwidx)
            start = _first_true(fh)
            place_head = head_exists & fh.any(dim=1)
            blocked = head_exists & ~place_head
            pending = st.pend_hi > st.pend_lo
            anyfree = st.free.any(dim=1)
            # rule 4 — the heap's `elif`: idle pod, no ready head
            can_form = ~head_exists & pending & anyfree
            slot, sstart, do_bf = head, start, torch.zeros_like(place_head)
            if backfill:
                # rule 2 — bounded EASY lookahead: a blocked head admits at
                # most one window past its own
                max_win = torch.where(st.r_active, st.r_win, -1).amax(dim=1)
                can_look = (blocked & pending & anyfree
                            & (max_win == _take(st.r_win, head)))
            else:
                can_look = torch.zeros_like(place_head)
            st = form_window(st, can_look | can_form)
            if backfill:
                # rule 3 — EASY backfill: lowest-seq non-head candidate that
                # fits now and drains by the head's reserved start (free is
                # untouched on the blocked path, so `ftab` holds)
                can_scan = blocked & (st.r_active.sum(dim=1) > 1)
                t_res = _earliest_fit(st, hwidx)
                jr = _take(st.g_job, st.r_grp)                     # (B, R)
                fr = _take(ftab, jobs.widx[jr])                    # (B, R, 8)
                starts = _first_true(fr)
                durs = jobs.dur[jr]
                elig = (st.r_active & fr.any(dim=2) & (r_rng[None] != head[:, None])
                        & (st.now[:, None] + durs <= (t_res + 1e-9)[:, None])
                        & can_scan[:, None])
                cand = torch.argmin(torch.where(elig, st.r_seq, _BIG_SEQ), dim=1)
                do_bf = can_scan & elig.any(dim=1)
                slot = torch.where(place_head, head, cand)
                sstart = torch.where(place_head, start, _take(starts, cand))
            do_place = place_head | do_bf
            if telemetry:
                # wait histogram at placement, from the post-formation group log
                arr = _take(st.g_arr, _take(st.r_grp, slot)).clamp(0, A - 1)
                wait = st.now - _take(trace.t, arr)
                nb = ms.wait_hist.shape[1]
                ms = ms._replace(
                    wait_hist=_add(ms.wait_hist, torch.where(do_place, _wait_bucket(wait), nb),
                                   torch.ones_like(wait, dtype=i64)),
                    wait_sum=ms.wait_sum + torch.where(do_place, wait, 0.0),
                    places=ms.places + do_place.to(i64))
            st = _place(st, jobs, slot, sstart, do_bf, do_place)
            progress = place_head | can_look | do_bf | can_form
            return _advance(st, trace, ~progress, max_steps, ms)

        n_st = len(st)

        def step(flat):
            st, ms = _State(*flat[:n_st]), (MetricsState(*flat[n_st:]) if telemetry else None)
            go = _live(st, trace) & (st.err == 0)
            new_st, new_ms = body(st, ms)
            out = tuple(_select(go, new_st, st))
            return out + tuple(_select(go, new_ms, ms)) if telemetry else out

        def flags(flat):
            st = _State(*flat[:n_st])
            return (_live(st, trace) & (st.err == 0)).any()[None]

        loop = _Steps(step, flags, tuple(st) + (tuple(ms) if telemetry else ()), _SYNC_EVERY)
        iters, limit = 0, _iteration_limit(capacity)
        while True:
            (alive,) = loop.advance()
            iters += _SYNC_EVERY
            if not alive:
                break
            if iters > limit:
                raise RuntimeError("vectorized engine: iteration budget exceeded")
        run.stats = {"lanes": B, "iterations": iters, "formations": 0}
        st = _State(*loop.state[:n_st])
        return (st, MetricsState(*loop.state[n_st:])) if telemetry else st

    return run


def _records(st: _State, trace: TraceArrays, jobs: JobTable):
    """Per-arrival dispatch/finish lanes scattered from the group log."""
    dur = jobs.dur[st.g_job]                  # junk on unused rows; dropped
    zero = torch.zeros_like(trace.t)
    return _put(zero, st.g_arr, st.g_t0), _put(zero, st.g_arr, st.g_t0 + dur)


def _summarize(st, trace: TraceArrays, dispatch, finish, solo8) -> SweepSummary:
    """Shared summary tail over per-arrival dispatch/finish lanes."""
    B, A = trace.t.shape
    valid = torch.arange(A, device=trace.t.device)[None] < trace.n[:, None]
    wait = dispatch - trace.t
    turnaround = finish - trace.t
    makespan = torch.where(valid, finish, 0.0).amax(dim=1)
    solo = torch.where(valid, solo8, 0.0).sum(dim=1)
    nz = makespan > 0
    n = valid.sum(dim=1).clamp_min(1)
    return SweepSummary(
        makespan=makespan,
        throughput=torch.where(nz, solo / makespan, 0.0),
        mean_wait=torch.where(valid, wait, 0.0).sum(dim=1) / n,
        p50_wait=_percentile(wait, valid, 50.0),
        p99_wait=_percentile(wait, valid, 99.0),
        mean_turnaround=torch.where(valid, turnaround, 0.0).sum(dim=1) / n,
        p95_turnaround=_percentile(turnaround, valid, 95.0),
        utilization=torch.where(nz, st.busy_time / makespan, 0.0),
        slice_utilization=torch.where(nz, st.slice_busy.sum(dim=1) / (N_UNITS * makespan), 0.0),
        backfills=st.backfills, dispatches=st.dispatches, err=st.err)


def _summary(st: _State, trace: TraceArrays, jobs: JobTable) -> SweepSummary:
    dispatch, finish = _records(st, trace, jobs)
    return _summarize(st, trace, dispatch, finish, jobs.solo8[trace.job])


# ------------------------------------------------------------ host tables

def metrics_dict(ms: MetricsState) -> dict:
    """Host-side dict of one lane's (or a pod-summed) :class:`MetricsState`
    (fields without the batch axis), keyed like the heap registry."""
    counts = np.asarray(torch.as_tensor(ms.wait_hist).cpu())
    return {
        "wait_s": {"edges": list(WAIT_BUCKETS_S), "counts": counts.tolist(),
                   "sum": float(ms.wait_sum), "count": int(counts.sum())},
        "queue_depth_integral_s": float(ms.queue_depth_int),
        "busy_unit_s": float(ms.busy_unit_int),
        "groups_placed": int(ms.places),
    }


def compile_trace(trace: list[Arrival], capacity: int, names: dict[str, int] | None = None,
                  jobs: list | None = None, device: str | torch.device = "cuda"
                  ) -> tuple[TraceArrays, list]:
    """Sort + pad one trace into :class:`TraceArrays` on ``device``.

    ``names``/``jobs`` accumulate the distinct-job table across the traces
    of a sweep (keyed by profile name), so a batch shares one job table.
    Returns the sorted arrival list alongside."""
    if len(trace) > capacity:
        raise ValueError(
            f"trace has {len(trace)} arrivals > capacity {capacity}; "
            f"the event table is fixed-size — raise `capacity`")
    order = sorted(trace, key=lambda a: a.t)
    names = {} if names is None else names
    jobs = [] if jobs is None else jobs
    rows = []
    for a in order:
        r = names.setdefault(a.profile.name, len(names))
        if r == len(jobs):
            jobs.append(a.profile)
        rows.append(r)
    t = np.full(capacity, np.inf, np.float32)
    t[:len(order)] = [a.t for a in order]
    job = np.zeros(capacity, np.int64)
    job[:len(rows)] = rows
    return TraceArrays(t=torch.as_tensor(t, device=device), job=torch.as_tensor(job, device=device),
                       n=torch.tensor(len(order), dtype=torch.int64, device=device)), order


def stack_traces(compiled: list[TraceArrays], device: str | torch.device | None = None
                 ) -> TraceArrays:
    """Compiled traces stacked along a new leading batch axis (moved to
    ``device`` when given)."""
    out = TraceArrays(*(torch.stack(xs) for xs in zip(*compiled)))
    return out if device is None else TraceArrays(*(x.to(device) for x in out))


def build_job_table(jobs: list, device: str | torch.device = "cuda") -> JobTable:
    """Float64 per-job solo durations at the requested width, cast once —
    the heap's per-group ``corun`` predictions for solo placements."""
    table = solo_duration_table(jobs)                 # (J, U) float64
    width = np.array([j.requested_units for j in jobs], np.int64)
    widx = np.searchsorted(np.asarray(UNIT_SIZES), width).astype(np.int64)
    dur = table[np.arange(len(jobs)), widx]
    solo8 = np.array([j.solo_time() for j in jobs], np.float64)
    return JobTable(width=torch.as_tensor(width, device=device),
                    widx=torch.as_tensor(widx, device=device),
                    dur=torch.as_tensor(dur.astype(np.float32), device=device),
                    solo8=torch.as_tensor(solo8.astype(np.float32), device=device))


def _lanes_np(tree) -> list:
    """A batched NamedTuple on the host: one NamedTuple of numpy arrays a
    lane (one device-to-host copy a field)."""
    fields = [x.detach().cpu().numpy() for x in tree]
    return [type(tree)(*(f[i] for f in fields)) for i in range(fields[0].shape[0])]


def _emit_lane(st: _State, jt: JobTable, records: list[JobRecord], pod: int = 0) -> list[Segment]:
    """Scatter one lane's group log (numpy fields) into its ``JobRecord``s
    and return the lane's :class:`Segment`s in placement order."""
    g_n = int(st.n_groups)
    g_arr = st.g_arr[:g_n]
    g_t0 = st.g_t0[:g_n]
    g_job = st.g_job[:g_n]
    g_dur = jt.dur.cpu().numpy()[g_job]
    g_w = jt.width.cpu().numpy()[g_job]
    pack = st.g_pack[:g_n]
    g_pseq, g_start, g_bf = pack >> 4, (pack >> 1) & 7, (pack & 1) == 1
    labels = {w: solo_partition(int(w)).label for w in set(g_w.tolist())}
    for g in range(g_n):
        rec = records[int(g_arr[g])]
        rec.dispatch = float(g_t0[g])
        rec.finish = float(g_t0[g] + g_dur[g])
        rec.group_size = 1
        rec.partition = labels[int(g_w[g])]
        rec.units = int(g_w[g])
        rec.backfilled = bool(g_bf[g])
        rec.pod = pod
    return [Segment(t0=float(g_t0[g]), t1=float(g_t0[g] + g_dur[g]), jobs=1,
                    partition=labels[int(g_w[g])], slices=((int(g_start[g]), int(g_w[g])),),
                    backfilled=bool(g_bf[g]), pod=pod)
            for g in np.argsort(g_pseq, kind="stable")]


# ------------------------------------------------------------- RL serving

class RLJobTable(NamedTuple):
    """Distinct-job lanes for the RL engine (row ``J`` = padding).  The job
    list is padded to a power-of-two row count (repeating job 0), as the
    reference pads it to bound its retraces."""

    widx: torch.Tensor           # (J+1,) int64 — requested width index
    dur_wu: torch.Tensor         # (J+1, U) f32 — solo makespan per width (f64, cast once)
    solo8: torch.Tensor          # (J+1,) f32 — full-pod solo time
    terms: JobTermsTable         # (J+1, ...) — roofline terms + features


def build_rl_job_table(jobs: list, device: str | torch.device = "cuda") -> RLJobTable:
    J = max(8, 1 << max(0, len(jobs) - 1).bit_length())
    padded = list(jobs) + [jobs[0]] * (J - len(jobs))
    tab = solo_duration_table(padded)                 # (J, U) float64
    width = np.array([j.requested_units for j in padded], np.int64)
    widx = np.searchsorted(np.asarray(UNIT_SIZES), width).astype(np.int64)
    U = len(UNIT_SIZES)
    return RLJobTable(
        widx=torch.as_tensor(np.concatenate([widx, [U - 1]]).astype(np.int64), device=device),
        dur_wu=torch.as_tensor(np.concatenate([tab, np.zeros((1, U))]).astype(np.float32),
                               device=device),
        solo8=torch.as_tensor(np.concatenate([[j.solo_time() for j in padded], [0.0]])
                              .astype(np.float32), device=device),
        terms=job_terms_table(padded, device=device))


class TrainRollout(NamedTuple):
    """Per-trace training logs of the ``train=True`` RL engine (leading
    batch axis B).  Row ``w`` of the ``(A, T_EP, ...)`` lanes holds window
    ``w``'s episode — the observations the agent saw, the (ε-greedy)
    actions it took, the validity masks, and a per-step ``valid`` flag
    (False once the episode is done or the window never formed).
    ``w_wait`` / ``w_turn`` are the queueing outcome attributed back to the
    window that formed each placed entry, so summing the buckets gives the
    serving engine's per-record wait/turnaround totals."""

    obs: torch.Tensor            # (B, A, T_EP, D) f32
    act: torch.Tensor            # (B, A, T_EP) int64
    mask: torch.Tensor           # (B, A, T_EP, W+P) bool
    valid: torch.Tensor          # (B, A, T_EP) bool
    w_wait: torch.Tensor         # (B, A) f32 — Σ member waits per window
    w_turn: torch.Tensor         # (B, A) f32 — Σ member turnarounds per window


class _RLState(NamedTuple):
    """RL-engine lanes: the time-sharing state plus the grouped-entry log.
    An entry (one heap ``Placement``) carries up to ``C = c_max`` members;
    solo entries use partition row 0 (the full-pod solo) with the fitted
    width in ``g_uidx``."""

    now: torch.Tensor
    pend_lo: torch.Tensor
    pend_hi: torch.Tensor
    profiled: torch.Tensor
    free: torch.Tensor
    r_active: torch.Tensor
    r_seq: torch.Tensor
    r_win: torch.Tensor
    r_grp: torch.Tensor
    next_seq: torch.Tensor
    c_active: torch.Tensor
    c_t1: torch.Tensor
    c_mask: torch.Tensor
    n_busy: torch.Tensor
    busy_t0: torch.Tensor
    busy_time: torch.Tensor
    slice_busy: torch.Tensor
    dispatches: torch.Tensor
    backfills: torch.Tensor
    refits: torch.Tensor         # (B,) — pod-width decompositions
    n_groups: torch.Tensor
    place_seq: torch.Tensor
    steps: torch.Tensor
    err: torch.Tensor
    g_arr: torch.Tensor          # (B, A, C) — member arrival index
    g_job: torch.Tensor          # (B, A, C) — member job row
    g_size: torch.Tensor         # (B, A) — member count
    g_pidx: torch.Tensor         # (B, A) — planned partition row
    g_uidx: torch.Tensor         # (B, A, C) — fitted per-slot width index
    g_dur: torch.Tensor          # (B, A) f32 — claim horizon (makespan)
    g_ft: torch.Tensor           # (B, A, C) f32 — per-slot finish offsets
    g_start: torch.Tensor        # (B, A, C) — per-slice start offsets
    g_t0: torch.Tensor           # (B, A) f32 — placement time
    g_pack: torch.Tensor         # (B, A) — (pseq << 1) | backfilled


class _Buckets(NamedTuple):
    """The rollout's per-window queueing buckets (the part of a
    :class:`TrainRollout` the service loop writes)."""

    w_wait: torch.Tensor
    w_turn: torch.Tensor


def _stacked_params(param_list: list[dict]) -> dict:
    """A population of DQN params as one dict of stacked leaves (G leading)."""
    return {k: torch.stack([p[k] for p in param_list]) for k in param_list[0]}


def _greedy_actions(params: dict, obs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Greedy masked actions of B lanes.  ``params`` is one agent's dict
    (every lane) or a stacked population (G leading; the lanes are G equal
    consecutive groups, group g served by agent g).  A population's groups
    run one forward each, at the shape a single-agent call of the same lanes
    has, so agent g's Q-values are bit for bit those of its own sweep."""
    if params["w0"].dim() == 2:
        return greedy_q_action(params, obs, mask).to(torch.int64)
    G = params["w0"].shape[0]
    return torch.cat([greedy_q_action({k: v[g] for k, v in params.items()}, o, m)
                      for g, (o, m) in enumerate(zip(obs.chunk(G), mask.chunk(G)))]).to(torch.int64)


def _build_run_rl(window: int, backfill: bool, capacity: int, telemetry: bool, env_cfg,
                  train: bool = False, device: str | torch.device = "cuda"):
    """The RL engine: ``run(trace, rjt, params, width)`` over a batch of
    traces; with ``train=True`` also ``eps`` and the episode draws.

    The service body is the time-sharing engine's generalized to
    multi-slice entries; where the time-sharing engine would form a window,
    a lane sets ``want`` and waits, and ``form_and_plan`` then runs the
    window-formation seam for every waiting lane: observation assembly, the
    greedy DQN episode, the §IV-A fallback guard, pod-width fitting and the
    dedicated-slice shrink.

    ``train=True`` (the rollout collector): the episode acts ε-greedily
    over the same mask and ``run`` also returns a :class:`TrainRollout`.
    Step ``t`` of window ``w`` of lane ``b`` explores iff
    ``u_explore[b, w, t] < eps``, and then takes the valid action of largest
    ``u_scores[b, w, t]`` (uniforms in [0, 1)).  ``eps == 0`` reproduces the
    serving engine's decisions.  ``run.stats`` holds the last call's lane,
    service-iteration and ``form_and_plan`` call counts.
    """
    assert window <= env_cfg.window, (window, env_cfg.window)
    dev = torch.device(device)
    W, C, obs_ctx = env_cfg.window, env_cfg.c_max, env_cfg.obs_context
    parts = enumerate_partitions(C)
    P = len(parts)
    ptable = build_partition_table(parts, C, device=dev)
    # per-(partition, slot) masks: dedicated slice (one share: shrinks to the
    # member's requested width) and first slot of its slice
    ded = np.zeros((P, C), bool)
    first = np.zeros((P, C), bool)
    for p_i, p in enumerate(parts):
        seen: set[int] = set()
        for s_i, (si, s, _b) in enumerate(p.slots):
            ded[p_i, s_i] = len(s.shares) == 1
            if si not in seen:
                first[p_i, s_i] = True
                seen.add(si)
    ded_t, first_t = torch.as_tensor(ded, device=dev), torch.as_tensor(first, device=dev)
    # the co-run model is ~7k small kernels a call: on the card it replays
    # from a CUDA graph (one capture per batch shape)
    metrics = (GraphedGroupMetrics(ptable) if dev.type == "cuda"
               else functools.partial(group_metrics, ptable))
    k = _consts(dev)
    U = len(UNIT_SIZES)
    A, R = capacity, 2 * window + 2
    T_EP = 2 * W                 # selects + closes bound any episode
    max_steps = 2 * capacity + 4
    f32, i64 = torch.float32, torch.int64
    c_rng = torch.arange(C, device=dev)
    w_rng = torch.arange(W, device=dev)
    i_w = torch.arange(window, device=dev)          # window slots, and entry rows
    r_rng = torch.arange(R, device=dev)
    p_rng = torch.arange(window * C, device=dev)

    def slice_widths(p, uidx):
        """Per-slice (width index, validity) of partition rows ``p`` (...,)
        under fitted per-slot widths ``uidx`` (..., C) -> ((..., C), (..., C))."""
        eq = ((ptable.slot_slice[p][..., None, :] == c_rng[:, None])
              & ptable.slot_valid[p][..., None, :])
        svalid = eq.any(dim=-1)
        svec = torch.where(eq, uidx[..., None, :], -1).amax(dim=-1)
        return svec, svalid

    def fit_multi(free, svec, svalid):
        """First-fit-decreasing placement of each partition's slices onto
        ``free`` (..., 8): the reference's ``find_offsets``.  The stable sort
        of ``-units * C + index`` is Python's stable width-descending order.
        Returns (all fit, per-slice starts, claimed union mask)."""
        units = k.units[svec.clamp(0, U - 1)]
        key = torch.where(svalid, -units * C + c_rng, 2 ** 15)
        order = torch.argsort(key, dim=-1, stable=True)
        starts = torch.zeros_like(svec)
        ok = torch.ones(free.shape[:-1], dtype=torch.bool, device=dev)
        cur = free
        union = torch.zeros_like(free)
        for step in range(C):
            sid = order[..., step:step + 1]
            act = torch.gather(svalid, -1, sid)[..., 0]
            w_i = torch.gather(svec, -1, sid)[..., 0].clamp(0, U - 1)
            cand = k.aligned[w_i] & (cur[..., None, :] | ~k.covered[w_i]).all(dim=-1)
            has = cand.any(dim=-1)
            s0 = _first_true(cand)
            ok = ok & (has | ~act)
            m = _claim_units(s0, k.units[w_i]) & (act & has)[..., None]
            cur = cur & ~m
            union = union | m
            starts = starts.scatter(-1, sid, torch.where(act, s0, 0)[..., None])
        return ok, starts, union

    def place_rl(st: _RLState, slot, starts, union, backfilled, do) -> _RLState:
        g = _take(st.r_grp, slot)
        dur = _take(st.g_dur, g)
        mask = union & do[:, None]
        doi = do.to(i64)
        gt = torch.where(do, g, A)
        ct = torch.where(do, torch.argmin(st.c_active.to(torch.int32), dim=1), N_UNITS)
        rt = torch.where(do, slot, R)
        pack = (st.place_seq << 1) | backfilled.to(i64)
        return st._replace(
            free=st.free & ~mask,
            busy_t0=torch.where(do & (st.n_busy == 0), st.now, st.busy_t0),
            n_busy=st.n_busy + mask.sum(dim=1),
            c_active=_put(st.c_active, ct, True),
            c_t1=_put(st.c_t1, ct, st.now + dur),
            c_mask=_put(st.c_mask, ct, mask),
            slice_busy=st.slice_busy + torch.where(mask, dur[:, None], 0.0),
            g_t0=_put(st.g_t0, gt, st.now),
            g_start=_put(st.g_start, gt, starts),
            g_pack=_put(st.g_pack, gt, pack),
            place_seq=st.place_seq + doi,
            r_active=_put(st.r_active, rt, False),
            backfills=st.backfills + (do & backfilled).to(i64))

    def run(trace: TraceArrays, rjt: RLJobTable, params: dict, width: torch.Tensor,
            eps=None, u_explore=None, u_scores=None):
        B = trace.t.shape[0]
        assert trace.t.shape[1] == A, (trace.t.shape, A)
        Jp = rjt.widx.shape[0] - 1               # padding row index
        pod_widx = torch.searchsorted(k.units, width.contiguous())
        tt = rjt.terms
        if train:
            D = W * (tt.features.shape[1] + 5) + (N_UNITS + W + 1 if obs_ctx else 0)
            roll = TrainRollout(
                obs=torch.zeros((B, A, T_EP, D), dtype=f32, device=dev),
                act=torch.zeros((B, A, T_EP), dtype=i64, device=dev),
                mask=torch.zeros((B, A, T_EP, W + P), dtype=torch.bool, device=dev),
                valid=torch.zeros((B, A, T_EP), dtype=torch.bool, device=dev),
                w_wait=torch.zeros((B, A), dtype=f32, device=dev),
                w_turn=torch.zeros((B, A), dtype=f32, device=dev))
        else:
            roll = None

        def z(*shape, dtype=i64):
            return torch.zeros((B, *shape), dtype=dtype, device=dev)

        st = _RLState(
            now=z(dtype=f32), pend_lo=z(), pend_hi=z(), profiled=z(Jp, dtype=torch.bool),
            free=k.unit_idx[None] < width[:, None],
            r_active=z(R, dtype=torch.bool), r_seq=z(R), r_win=z(R), r_grp=z(R),
            next_seq=z(), c_active=z(N_UNITS, dtype=torch.bool), c_t1=z(N_UNITS, dtype=f32),
            c_mask=z(N_UNITS, N_UNITS, dtype=torch.bool), n_busy=z(), busy_t0=z(dtype=f32),
            busy_time=z(dtype=f32), slice_busy=z(N_UNITS, dtype=f32), dispatches=z(),
            backfills=z(), refits=z(), n_groups=z(), place_seq=z(), steps=z(), err=z(),
            g_arr=torch.full((B, A, C), A, dtype=i64, device=dev),
            g_job=torch.full((B, A, C), Jp, dtype=i64, device=dev),
            g_size=z(A), g_pidx=z(A), g_uidx=z(A, C), g_dur=z(A, dtype=f32),
            g_ft=z(A, C, dtype=f32), g_start=z(A, C), g_t0=z(A, dtype=f32), g_pack=z(A))
        ms = _metrics_init(B, dev) if telemetry else None

        def form_and_plan(st: _RLState, roll, do):
            # ---- pop & first-sight protocol (as in _make_form_window)
            kk = torch.where(do, torch.clamp_max(st.pend_hi - st.pend_lo, window), 0)
            on = i_w[None] < kk[:, None]
            arr = (st.pend_lo[:, None] + i_w).clamp(0, A - 1)
            jrow = _take(trace.job, arr)
            earlier_same = ((jrow[:, None, :] == jrow[:, :, None])
                            & (i_w[None, :] < i_w[:, None]) & on[:, None, :])
            fs = on & ~earlier_same.any(dim=2) & ~_take(st.profiled, jrow)
            profiled = _put(st.profiled, torch.where(on, jrow, Jp), True)
            n_fs = fs.sum(dim=1)
            rank_fs = fs.cumsum(dim=1) - 1
            planned = ~fs & on
            rank_pl = planned.cumsum(dim=1) - 1
            n_pl = planned.sum(dim=1)

            # ---- the profiled chunk as env-window queue rows (<= W)
            pt = torch.where(planned, rank_pl, W)
            pl_job = _put(torch.full((B, W), Jp, dtype=i64, device=dev), pt, jrow)
            pl_arr = _put(torch.full((B, W), A, dtype=i64, device=dev), pt, arr)
            pl_valid = w_rng[None] < n_pl[:, None]
            one_b = torch.ones(B, dtype=f32, device=dev)
            qa = QueueArrays(
                features=tt.features[pl_job], valid=pl_valid, comp=tt.comp[pl_job],
                mem=tt.mem[pl_job], collb=tt.collb[pl_job], colll=tt.colll[pl_job],
                fixedt=tt.fixedt[pl_job], steps=tt.steps[pl_job], solo=tt.solo[pl_job],
                cpct=tt.cpct[pl_job], mpct=tt.mpct[pl_job],
                mean_c=one_b, mean_m=one_b, mean_d=one_b)
            if obs_ctx:
                # the dispatch context in f32: busy mask, per-slot ages,
                # pending depth left behind (the heap's snapshot is f64)
                busy_f = (~st.free).to(f32)
                age = st.now[:, None] - _take(trace.t, pl_arr.clamp(0, A - 1))
                ages_f = torch.where(pl_valid, torch.log10(1.0 + age.clamp_min(0.0)) / 6.0, 0.0)
                depth = torch.clamp_max((st.pend_hi - st.pend_lo - kk).to(f32) / (4.0 * W), 1.0)
                ctx_vec = torch.cat([busy_f, ages_f, depth[:, None]], dim=1)
            if train:
                win = st.dispatches.clamp(0, A - 1)
                ue, us = _take(u_explore, win), _take(u_scores, win)   # (B, T_EP), (B, T_EP, W+P)

            # ---- the greedy co-schedule episode (CoScheduleEnv, batched)
            sched = torch.zeros((B, W), dtype=torch.bool, device=dev)
            gidx = torch.full((B, C), -1, dtype=i64, device=dev)
            gsize = z()
            pm = torch.full((B, W, C), -1, dtype=i64, device=dev)
            psize, ppidx, nplan = z(W), z(W), z()
            ys = []
            for t in range(T_EP):
                member = _put(torch.zeros((B, W), dtype=torch.bool, device=dev),
                              torch.where(c_rng[None] < gsize[:, None], gidx, W), True)
                avail = pl_valid & ~sched & ~member
                prog = gsize.to(f32) / float(max(1, C))
                flags = torch.stack([avail.to(f32), member.to(f32), sched.to(f32),
                                     (~pl_valid).to(f32),
                                     torch.where(pl_valid, prog[:, None], 0.0)], dim=2)
                obs = torch.cat([qa.features, flags], dim=2).reshape(B, -1)
                if obs_ctx:
                    obs = torch.cat([obs, ctx_vec], dim=1)
                mask = torch.cat([avail & (gsize < C)[:, None],
                                  (gsize >= 1)[:, None] & (ptable.arity[None] == gsize[:, None])],
                                 dim=1)
                done = (sched | ~pl_valid).all(dim=1) & (gsize == 0)
                act = _greedy_actions(params, obs, mask)
                if train:
                    # ε-greedy over the same mask: invalid lanes at -1, argmax wins
                    rand = torch.argmax(torch.where(mask, us[:, t], -1.0), dim=1)
                    act = torch.where(ue[:, t] < eps, rand, act)
                do_sel = ~done & (act < W)
                do_close = ~done & (act >= W)
                row = torch.where(do_close, nplan, W)
                pm = _put(pm, row, gidx)
                psize = _put(psize, row, gsize)
                ppidx = _put(ppidx, row, (act - W).clamp(0, P - 1))
                sched = sched | (member & do_close[:, None])
                gidx = _put(gidx, torch.where(do_sel, gsize.clamp(0, C - 1), C), act)
                gidx = torch.where(do_close[:, None], -1, gidx)
                gsize = torch.where(do_close, 0, gsize + do_sel.to(i64))
                nplan = nplan + do_close.to(i64)
                if train:
                    ys.append((obs, act, mask, ~done))
            done_f = (sched | ~pl_valid).all(dim=1) & (gsize == 0)
            err_ep = torch.where(do & ~done_f, ERR_EPISODE, 0)
            if train:
                wrow = torch.where(do, st.dispatches, A)
                o_y, a_y, m_y, v_y = (torch.stack(x, dim=1) for x in zip(*ys))
                roll = roll._replace(obs=_put(roll.obs, wrow, o_y), act=_put(roll.act, wrow, a_y),
                                     mask=_put(roll.mask, wrow, m_y),
                                     valid=_put(roll.valid, wrow, v_y))

            # ---- §IV-A fallback + pod-width fitting, over planned rows
            row_on = w_rng[None] < nplan[:, None]                          # (B, W)
            mvalid = (c_rng[None, None] < psize[..., None]) & row_on[..., None]
            mslot = pm.clamp(0, W - 1)
            mjob = torch.where(mvalid, _take(pl_job, mslot.reshape(B, -1)).reshape(B, W, C), Jp)
            mwidx = rjt.widx[mjob]
            uplan = ptable.slot_units_idx[ppidx]
            uidx_fit = torch.where(ded_t[ppidx], torch.minimum(uplan, mwidx), uplan)
            # the planned and the fitted co-runs as one batch of 2 x B x W
            # groups: the planned rows' widths are the partition's own
            # (what group_metrics takes when units_idx is None)
            qa_rows = QueueArrays(*(x[:, None].expand(B, W, *x.shape[1:]).reshape(
                B * W, *x.shape[1:]) for x in qa))
            qa2 = QueueArrays(*(torch.cat([x, x]) for x in qa_rows))
            mk2, solo2, _ri, ft2 = metrics(
                qa2, torch.cat([pm, pm]).reshape(2 * B * W, C),
                torch.cat([psize, psize]).reshape(-1), torch.cat([ppidx, ppidx]).reshape(-1),
                units_idx=torch.cat([uplan, uidx_fit]).reshape(2 * B * W, C), with_finish=True)
            mk_plan = mk2[:B * W].reshape(B, W)
            solo_sum = solo2[:B * W].reshape(B, W)
            ft_fit = ft2[B * W:].reshape(B, W, C)
            mk_fit = ft_fit.amax(dim=2)
            fallback = row_on & (psize > 1) & (mk_plan > solo_sum)
            wfit = k.units[uidx_fit]
            ftot = torch.where(first_t[ppidx] & ptable.slot_valid[ppidx], wfit, 0).sum(dim=2)
            refit = row_on & ~fallback & (ftot > width[:, None])
            split = fallback | refit
            solo_widx = torch.minimum(mwidx, pod_widx[:, None, None])
            solo_dur = rjt.dur_wu[mjob, solo_widx]
            fs_widx = torch.minimum(rjt.widx[jrow], pod_widx[:, None])
            fs_dur = rjt.dur_wu[jrow, fs_widx]
            refits_add = (refit.sum(dim=1)
                          + (fallback[..., None] & mvalid
                             & (mwidx > pod_widx[:, None, None])).sum(dim=(1, 2))
                          + (fs & (rjt.widx[jrow] > pod_widx[:, None])).sum(dim=1))

            # ---- entry expansion, in schedule order: first-sight solos, then
            # plan rows (split rows decompose to members in place).  Each
            # entry row is written once, whole (the other slots keep their
            # initial values)
            E = torch.where(row_on, torch.where(split, psize, 1), 0)
            off = n_fs[:, None] + E.cumsum(dim=1) - E
            n_ent = n_fs + E.sum(dim=1)
            EN = window
            zc = torch.zeros((B, 1, C - 1), dtype=i64, device=dev)
            zcf = torch.zeros((B, 1, C - 1), dtype=f32, device=dev)
            jpc = torch.full((B, 1, C - 1), Jp, dtype=i64, device=dev)

            def col0(v, fill):
                """Rows (B, n, C) holding ``v`` (B, n) in slot 0, ``fill`` after."""
                return torch.cat([v[..., None], fill.expand(B, v.shape[1], C - 1)], dim=2)

            tfs = torch.where(fs, rank_fs, EN)
            tg = torch.where(row_on & ~split, off, EN)
            tsp = torch.where(split[..., None] & mvalid, off[..., None] + c_rng, EN).reshape(B, -1)
            one = psize == 1
            # kept plan rows: single-member groups take the exact f64 solo
            # duration (the heap's corun); true co-run groups the f32 model
            grp_dur = torch.where(one, rjt.dur_wu[mjob[..., 0], uidx_fit[..., 0]], mk_fit)
            grp_ft = torch.where(one[..., None],
                                 torch.where(c_rng == 0, grp_dur[..., None], 0.0), ft_fit)
            sdur = solo_dur.reshape(B, -1)
            tgt = torch.cat([tfs, tg, tsp], dim=1)

            def ent(init, v_fs, v_g, v_sp):
                return _put(init, tgt, torch.cat([v_fs, v_g, v_sp], dim=1))

            ent_job = ent(torch.full((B, EN, C), Jp, dtype=i64, device=dev),
                          col0(jrow, jpc), mjob, col0(mjob.reshape(B, -1), jpc))
            ent_size = ent(z(EN), torch.ones_like(jrow), psize, torch.ones_like(tsp))
            ent_pidx = ent(z(EN), torch.zeros_like(jrow), ppidx, torch.zeros_like(tsp))
            ent_uidx = ent(z(EN, C), col0(fs_widx, zc), uidx_fit,
                           col0(solo_widx.reshape(B, -1), zc))
            ent_dur = ent(z(EN, dtype=f32), fs_dur, grp_dur, sdur)
            ent_ft = ent(z(EN, C, dtype=f32), col0(fs_dur, zcf), grp_ft, col0(sdur, zcf))
            # submission attribution is name-keyed FIFO in entry order (the
            # heap's by_name deques): the o-th entry member of a job row
            # serves the o-th popped arrival of that row
            flat_job = ent_job.reshape(B, EN * C)
            occ_ent = ((flat_job[:, None, :] == flat_job[:, :, None])
                       & (p_rng[None, :] < p_rng[:, None])).sum(dim=2)
            occ_pop = earlier_same.sum(dim=2)
            amatch = ((jrow[:, None, :] == flat_job[:, :, None])
                      & (occ_pop[:, None, :] == occ_ent[:, :, None]) & on[:, None, :])
            ent_arr = torch.where(amatch.any(dim=2),
                                  torch.where(amatch, arr[:, None, :], 0).amax(dim=2),
                                  A).reshape(B, EN, C)

            # ---- ring append (n_ent entries) + group-log scatter
            free_rank = (~st.r_active).cumsum(dim=1) - 1
            q = torch.where(~st.r_active & (free_rank < n_ent[:, None]), free_rank, -1)
            sel = q >= 0
            err_ring = torch.where((~st.r_active).sum(dim=1) < n_ent, ERR_READY_OVERFLOW, 0)
            grow = torch.where(i_w[None] < n_ent[:, None], st.n_groups[:, None] + i_w, A)
            new = st._replace(
                profiled=profiled,
                g_arr=_put(st.g_arr, grow, ent_arr), g_job=_put(st.g_job, grow, ent_job),
                g_size=_put(st.g_size, grow, ent_size), g_pidx=_put(st.g_pidx, grow, ent_pidx),
                g_uidx=_put(st.g_uidx, grow, ent_uidx), g_dur=_put(st.g_dur, grow, ent_dur),
                g_ft=_put(st.g_ft, grow, ent_ft),
                r_active=st.r_active | sel,
                r_seq=torch.where(sel, st.next_seq[:, None] + q, st.r_seq),
                r_win=torch.where(sel, st.dispatches[:, None], st.r_win),
                r_grp=torch.where(sel, st.n_groups[:, None] + q, st.r_grp),
                next_seq=st.next_seq + n_ent, n_groups=st.n_groups + n_ent,
                pend_lo=st.pend_lo + kk, refits=st.refits + refits_add,
                err=st.err | err_ep | err_ring, dispatches=st.dispatches + do.to(i64))
            return _select(do, new, st), roll

        def inner_body(st: _RLState, ms, bk, run_):
            head, head_exists = _head(st)
            hg = _take(st.r_grp, head)
            hsvec, hsvalid = slice_widths(_take(st.g_pidx, hg), _take(st.g_uidx, hg))
            if backfill:
                # one batched fit over the head, every ring slot and the
                # head against each replayed-expiry free map (the latter
                # are earliest_fit_multi's candidates)
                svecs, svalids = slice_widths(_take(st.g_pidx, st.r_grp),
                                              _take(st.g_uidx, st.r_grp))     # (B, R, C)
                n8 = N_UNITS
                oks, starts_all, unions = fit_multi(
                    torch.cat([st.free[:, None].expand(B, 1 + R, n8), _expiry_free_maps(st)],
                              dim=1),
                    torch.cat([hsvec[:, None], svecs, hsvec[:, None].expand(B, n8, C)], dim=1),
                    torch.cat([hsvalid[:, None], svalids, hsvalid[:, None].expand(B, n8, C)],
                              dim=1))
                ok_h, starts_h, union_h = oks[:, 0], starts_all[:, 0], unions[:, 0]
            else:
                ok_h, starts_h, union_h = fit_multi(st.free, hsvec, hsvalid)
            place_head = head_exists & ok_h
            blocked = head_exists & ~place_head
            pending = st.pend_hi > st.pend_lo
            anyfree = st.free.any(dim=1)
            can_form = ~head_exists & pending & anyfree
            if backfill:
                max_win = torch.where(st.r_active, st.r_win, -1).amax(dim=1)
                can_look = blocked & pending & anyfree & (max_win == _take(st.r_win, head))
            else:
                can_look = torch.zeros_like(place_head)
            want = can_look | can_form       # the lane waits for form_and_plan
            slot, sstarts, sunion = head, starts_h, union_h
            do_bf = torch.zeros_like(place_head)
            if backfill:
                # the heap scans in the same pass it forms; here the scan
                # waits one iteration (~want) so it sees the formed ring
                can_scan = blocked & ~want & (st.r_active.sum(dim=1) > 1)
                t_res = _earliest_time(st, oks[:, 1 + R:])       # earliest_fit_multi
                durs = _take(st.g_dur, st.r_grp)
                elig = (st.r_active & oks[:, 1:1 + R] & (r_rng[None] != head[:, None])
                        & (st.now[:, None] + durs <= (t_res + 1e-9)[:, None])
                        & can_scan[:, None])
                cand = torch.argmin(torch.where(elig, st.r_seq, _BIG_SEQ), dim=1)
                do_bf = can_scan & elig.any(dim=1)
                slot = torch.where(place_head, head, cand)
                sstarts = torch.where(place_head[:, None], starts_h,
                                      _take(starts_all[:, 1:1 + R], cand))
                sunion = torch.where(place_head[:, None], union_h, _take(unions[:, 1:1 + R], cand))
            do_place = place_head | do_bf
            g2 = _take(st.r_grp, slot)
            arrm = _take(st.g_arr, g2).clamp(0, A - 1)                    # (B, C)
            memv = c_rng[None] < _take(st.g_size, g2)[:, None]
            waits = st.now[:, None] - _take(trace.t, arrm)
            if telemetry:
                nb = ms.wait_hist.shape[1]
                ms = ms._replace(
                    wait_hist=_add(ms.wait_hist,
                                   torch.where(do_place[:, None] & memv, _wait_bucket(waits), nb),
                                   torch.ones_like(arrm)),
                    wait_sum=ms.wait_sum + torch.where(do_place[:, None] & memv, waits,
                                                       0.0).sum(dim=1),
                    places=ms.places + do_place.to(i64))
            if train:
                # queueing-reward attribution: the placed entry's member
                # waits/turnarounds land in the bucket of the window that
                # FORMED it (r_win).  Written only on running lanes (the
                # buckets are not part of the per-lane select)
                turns = st.now[:, None] + _take(st.g_ft, g2) - _take(trace.t, arrm)
                brow = torch.where(do_place & run_, _take(st.r_win, slot), A)[:, None]
                bk = bk._replace(
                    w_wait=_add(bk.w_wait, brow,
                                torch.where(memv, waits, 0.0).sum(dim=1, keepdim=True)),
                    w_turn=_add(bk.w_turn, brow,
                                torch.where(memv, turns, 0.0).sum(dim=1, keepdim=True)))
            st = place_rl(st, slot, sstarts, sunion, do_bf, do_place)
            st, ms = _advance(st, trace, ~do_place & ~want, max_steps, ms)
            return st, ms, bk, want

        # the service loop's state: the lanes, the metrics, the per-window
        # buckets (the rest of the rollout changes only at formations) and
        # each lane's `want`
        n_st, n_ms = len(st), (len(ms) if telemetry else 0)

        def unflat(flat):
            ms = MetricsState(*flat[n_st:n_st + n_ms]) if telemetry else None
            bk = _Buckets(*flat[n_st + n_ms:-1]) if train else None
            return _RLState(*flat[:n_st]), ms, bk, flat[-1]

        def flat_of(st, ms, bk, want):
            return (tuple(st) + (tuple(ms) if telemetry else ())
                    + (tuple(bk) if train else ()) + (want,))

        def step(flat):
            st, ms, bk, want = unflat(flat)
            run_ = _live(st, trace) & (st.err == 0) & ~want
            new_st, new_ms, bk, new_want = inner_body(st, ms, bk, run_)
            return flat_of(_select(run_, new_st, st),
                           _select(run_, new_ms, ms) if telemetry else None, bk,
                           torch.where(run_, new_want, want))

        def flags(flat):
            st, _, _, want = unflat(flat)
            return torch.stack([want.any(), (_live(st, trace) & (st.err == 0)).any()])

        buckets = _Buckets(roll.w_wait, roll.w_turn) if train else None
        loop = _Steps(step, flags, flat_of(st, ms, buckets,
                                           torch.zeros(B, dtype=torch.bool, device=dev)),
                      _SYNC_EVERY)
        # a lane also idles up to _SYNC_EVERY iterations before each formation
        iters, forms, limit = 0, 0, _iteration_limit(capacity) * (_SYNC_EVERY + 1)
        while True:
            any_want, any_alive = loop.advance()
            iters += _SYNC_EVERY
            if any_want:
                st, ms, buckets, want = unflat(loop.state)
                st, roll = form_and_plan(st, roll, want)
                loop.set(flat_of(st, ms, buckets, torch.zeros_like(want)))
                forms += 1
            elif not any_alive:
                break
            if iters > limit:
                raise RuntimeError("vectorized engine: iteration budget exceeded")
        run.stats = {"lanes": B, "iterations": iters, "formations": forms}
        st, ms, buckets, _ = unflat(loop.state)
        out = (st, ms) if telemetry else (st,)
        out = out + (roll._replace(w_wait=buckets.w_wait, w_turn=buckets.w_turn),) \
            if train else out
        return out if len(out) > 1 else out[0]

    return run


def _records_rl(st: _RLState, trace: TraceArrays):
    B, A = trace.t.shape
    C = st.g_arr.shape[2]
    memv = torch.arange(C, device=trace.t.device)[None, None] < st.g_size[..., None]
    tgt = torch.where(memv, st.g_arr, A).reshape(B, -1)
    zero = torch.zeros_like(trace.t)
    dispatch = _put(zero, tgt, st.g_t0[..., None].expand(st.g_arr.shape).reshape(B, -1))
    finish = _put(zero, tgt, (st.g_t0[..., None] + st.g_ft).reshape(B, -1))
    return dispatch, finish


def _summary_rl(st: _RLState, trace: TraceArrays, rjt: RLJobTable) -> SweepSummary:
    dispatch, finish = _records_rl(st, trace)
    return _summarize(st, trace, dispatch, finish, rjt.solo8[trace.job])


def make_rollout_collector(env_cfg, window: int = 8, backfill: bool = True,
                           capacity: int = 256, device: str | torch.device = "cuda"):
    """The sim-in-the-loop rollout collector.

    Returns ``collect(traces, rjt, params, eps, widths, *, u_explore=None,
    u_scores=None, generator=None)``: ``traces`` a stacked
    :class:`TraceArrays` batch (leading axis B), ``eps`` the exploration
    rate shared by the batch, ``widths`` (B,) pod widths.  The episode
    draws are ``u_explore`` (B, A, T_EP) and ``u_scores``
    (B, A, T_EP, W+P), indexed by (window id, step); when not given they
    are drawn on the host from ``generator`` (so a seed gives the same
    draws on every device).  Yields ``(SweepSummary, TrainRollout)`` with
    leading axis B — the summary carries the makespan and the ``err``
    lane (callers must check it).  With ``eps=0`` the decisions are the
    serving engine's."""
    runf = _build_run_rl(window, backfill, capacity, False, env_cfg, train=True, device=device)
    n_act = env_cfg.window + len(enumerate_partitions(env_cfg.c_max))
    T_EP = 2 * env_cfg.window

    def collect(traces: TraceArrays, rjt: RLJobTable, params: dict, eps, widths, *,
                u_explore=None, u_scores=None, generator: torch.Generator | None = None):
        B = traces.t.shape[0]
        dev = traces.t.device
        if u_explore is None:
            u_explore = torch.rand((B, capacity, T_EP), generator=generator)
        if u_scores is None:
            u_scores = torch.rand((B, capacity, T_EP, n_act), generator=generator)
        u_explore = torch.as_tensor(u_explore, dtype=torch.float32).to(dev)
        u_scores = torch.as_tensor(u_scores, dtype=torch.float32).to(dev)
        st, roll = runf(traces, rjt, params, widths, float(eps), u_explore, u_scores)
        return _summary_rl(st, traces, rjt), roll

    return collect


def _emit_lane_rl(st: _RLState, jobs: list, parts: list, records: list[JobRecord],
                  pod: int = 0) -> list[Segment]:
    """RL mirror of ``_emit_lane``: rebuild each entry's fitted partition
    from the logged per-slot widths (the ``to_placements`` shrink) and
    recompute its record times with the f64 ``corun`` the heap stores, so
    only the placement clock carries f32 rounding."""
    g_n = int(st.n_groups)
    g_pseq, g_bf = st.g_pack[:g_n] >> 1, (st.g_pack[:g_n] & 1) == 1
    segs: list[tuple[int, Segment]] = []
    for g in range(g_n):
        size = int(st.g_size[g])
        group = [jobs[int(st.g_job[g, m])] for m in range(size)]
        planned = parts[int(st.g_pidx[g])]
        new_slices = list(planned.slices)
        changed = False
        for s_i, (si, s, _b) in enumerate(planned.slots):
            w = UNIT_SIZES[int(st.g_uidx[g, s_i])]
            if len(s.shares) == 1 and w < s.units:
                new_slices[si] = Slice(w, s.shares)
                changed = True
        part = (Partition(tuple(new_slices), slice_label(tuple(new_slices)))
                if changed else planned)
        pred = corun(group, part)
        t0 = float(st.g_t0[g])
        for m, (ft, (_si, s, _b)) in enumerate(zip(pred.finish_times, part.slots)):
            rec = records[int(st.g_arr[g, m])]
            rec.dispatch = t0
            rec.finish = t0 + float(ft)
            rec.group_size = size
            rec.partition = part.label
            rec.units = s.units
            rec.backfilled = bool(g_bf[g])
            rec.pod = pod
        ranges = tuple((int(st.g_start[g, si]), s.units) for si, s in enumerate(part.slices))
        segs.append((int(g_pseq[g]), Segment(
            t0=t0, t1=t0 + float(pred.makespan), jobs=size, partition=part.label,
            slices=ranges, backfilled=bool(g_bf[g]), pod=pod)))
    return [s for _, s in sorted(segs, key=lambda x: x[0])]


def same_device(a, b) -> bool:
    """``a`` and ``b`` name one device (an index-less ``cuda`` is any card's
    name for the current one)."""
    a, b = torch.device(a), torch.device(b)
    return a.type == b.type and (a.index is None or b.index is None or a.index == b.index)


def _check_agent_device(policy, device: torch.device) -> None:
    """An RL engine runs on its agent's device; nothing moves quietly."""
    if not same_device(policy.agent.device, device):
        raise ValueError(f"the RL policy's agent lives on {policy.agent.device}, the "
                         f"vectorized engine on {device}: build the engine on the "
                         f"agent's device")


class VectorizedClusterSimulator:
    """Batched engine for time-sharing and RL dispatch plans, on ``device``
    (the card unless the caller asks for the CPU).

    ``run(trace)`` returns a :class:`~repro_torch.online.simulator.SimResult`
    (records in sorted-trace order, timeline in placement order — the
    heap's shapes).  ``sweep(traces)`` runs a batch in one engine call and
    returns per-trace :class:`SweepSummary` lanes.  ``policy`` is a
    :class:`~repro_torch.online.policies.TimeSharingPolicy` (or ``None``)
    or an :class:`~repro_torch.online.policies.RLDispatchPolicy`, whose
    agent (on the engine's device) runs its episodes at the window seam;
    ``hot_swap`` between calls is seen by the next call, and
    ``sweep(..., param_sets=[...])`` scores a population of agents.  No
    ``on_tick`` and no ``mode="blocking"``: the heap is the path for both.
    """

    def __init__(self, policy=None, window: int = 8, backfill: bool = True,
                 capacity: int = 256, telemetry: bool = False, *,
                 device: str | torch.device = "cuda"):
        if not self.supports(policy):
            raise ValueError(
                f"vectorized engine serves TimeSharingPolicy or "
                f"RLDispatchPolicy plans; got {type(policy).__name__}")
        assert window >= 1
        self.policy = policy if policy is not None else TimeSharingPolicy()
        self.window = window
        self.backfill = backfill
        self.capacity = capacity
        self.telemetry = telemetry
        self.device = torch.device(device)
        self.last_metrics: dict | None = None
        self.last_sweep_metrics: MetricsState | None = None
        self._rl = isinstance(self.policy, RLDispatchPolicy)
        if self._rl:
            env_cfg = self.policy.scheduler.env_cfg
            if window > env_cfg.window:
                raise ValueError(
                    f"sim window {window} > agent window {env_cfg.window}: "
                    f"one formation would span several RL episodes "
                    f"(submission_protocol re-chunking); use a sim window "
                    f"<= EnvConfig.window")
            _check_agent_device(self.policy, self.device)
            self._env_cfg = env_cfg
            self._parts = enumerate_partitions(env_cfg.c_max)
            self._runf = _build_run_rl(window, backfill, capacity, telemetry, env_cfg,
                                       device=self.device)
        else:
            self._runf = _build_run(window, backfill, capacity, telemetry)

    @staticmethod
    def supports(policy) -> bool:
        """Policies this engine serves with decision-level heap parity."""
        return policy is None or isinstance(policy, (TimeSharingPolicy, RLDispatchPolicy))

    def _params(self) -> dict:
        _check_agent_device(self.policy, self.device)
        return self.policy.agent.params

    def _widths(self, n: int) -> torch.Tensor:
        return torch.full((n,), N_UNITS, dtype=torch.int64, device=self.device)

    # ---------------------------------------------------------------- run

    def run(self, trace: list[Arrival]) -> SimResult:
        res = SimResult(policy=getattr(self.policy, "name", "time_sharing"),
                        window=self.window, jobs=[], mode="concurrent")
        if not trace:
            return res
        jobs: list = []
        tr, order = compile_trace(trace, self.capacity, jobs=jobs, device="cpu")
        batch = stack_traces([tr], self.device)
        if self._rl:
            jt = build_rl_job_table(jobs, self.device)
            out = self._runf(batch, jt, self._params(), self._widths(1))
        else:
            jt = build_job_table(jobs, self.device)
            out = self._runf(batch, jt, self._widths(1))
        if self.telemetry:
            sts, mss = out
            self.last_metrics = metrics_dict(_lanes_np(mss)[0])
        else:
            sts = out
        st = _lanes_np(sts)[0]
        self._check_err(int(st.err))

        records = [JobRecord(binary=a.binary, name=a.profile.name, arrival=a.t,
                             solo_time=a.profile.solo_time(), idx=i,
                             job_class=a.profile.job_class)
                   for i, a in enumerate(order)]
        res.jobs = records
        if self._rl:
            res.timeline = _emit_lane_rl(st, jobs, self._parts, records)
            res.refits = int(st.refits)
        else:
            res.timeline = _emit_lane(st, jt, records)
        res.busy_time = float(st.busy_time)
        res.dispatches = int(st.dispatches)
        res.backfills = int(st.backfills)
        res.slice_busy_s = [float(x) for x in st.slice_busy]
        return res

    # -------------------------------------------------------------- sweep

    def sweep(self, traces: list[list[Arrival]], devices=None, with_metrics: bool = False,
              param_sets=None):
        """Run ``traces`` as the lanes of one engine call.

        With ``with_metrics=True`` (a ``telemetry=True`` engine) returns
        ``(SweepSummary, MetricsState)``, batch axis leading; a telemetry
        engine keeps the metrics in ``last_sweep_metrics`` either way.

        ``param_sets`` (RL engines only): a list of DQN param dicts (or one
        dict of stacked leaves) adds a leading *population* axis — the
        summary's lanes are ``(n_params, n_traces)``, every agent scored on
        every trace in one call.  Exclusive of ``with_metrics``; ``devices``
        is ignored, as the reference ignores it there.

        ``devices`` shards the batch, as the reference's ``pmap`` does:

        * a list: one device, or a count that does not divide
          ``len(traces)``, runs the unsharded sweep (which device is not
          read, as the reference's fallback does not read it).  Otherwise
          it raises ``ValueError``: a device listed twice, as ``pmap``
          refuses it; several distinct devices, since the port runs one
          process a card and shards over a ``DeviceMesh``.
        * a 1-D ``DeviceMesh`` whose every rank calls ``sweep`` with the
          same traces, each on an engine on its own device: rank ``r`` runs
          lanes ``[r*k, (r+1)*k)``, ``k = len(traces) // mesh.size()``
          (the reference's ``reshape((n_dev, T // n_dev))``), and the lanes
          of the summary and the metrics are all-gathered over the mesh's
          group, so every rank returns the whole batch.  A size that does
          not divide the batch runs it unsharded on every rank.  The error
          lanes are read after the gather, so every rank raises alike.
        """
        if not traces:
            raise ValueError("empty sweep")
        if with_metrics and not self.telemetry:
            raise ValueError("with_metrics needs an engine built with telemetry=True")
        if param_sets is not None and not self._rl:
            raise ValueError("param_sets needs an RLDispatchPolicy engine")
        if param_sets is not None and with_metrics:
            raise ValueError("param_sets and with_metrics are exclusive")
        names: dict[str, int] = {}
        jobs: list = []
        compiled = [compile_trace(t, self.capacity, names, jobs, device="cpu")[0]
                    for t in traces]
        batch = stack_traces(compiled, self.device)
        T = len(traces)
        if self._rl:
            jt = build_rl_job_table(jobs, self.device)
            if param_sets is not None:
                stacked = (param_sets if isinstance(param_sets, dict)
                           else _stacked_params(list(param_sets)))
                for v in stacked.values():
                    if not same_device(v.device, self.device):
                        raise ValueError(f"param_sets live on {v.device}, the engine on "
                                         f"{self.device}")
                G = stacked["w0"].shape[0]
                rep = TraceArrays(*(x.repeat(G, *([1] * (x.dim() - 1))) for x in batch))
                st = self._runf(rep, jt, stacked, self._widths(G * T))
                summ = SweepSummary(*(x.reshape(G, T) for x in _summary_rl(st, rep, jt)))
                self._check_err(int(summ.err.max()))
                return summ
        else:
            jt = build_job_table(jobs, self.device)
        group = self._shard_group(devices, T)
        if group is not None:
            n = dist.get_world_size(group)
            k = T // n
            lo = dist.get_rank(group) * k
            batch = TraceArrays(*(x[lo:lo + k] for x in batch))
        if self._rl:
            out = self._runf(batch, jt, self._params(), self._widths(batch.t.shape[0]))
        else:
            out = self._runf(batch, jt, self._widths(batch.t.shape[0]))
        st, ms = out if self.telemetry else (out, None)
        summ = _summary_rl(st, batch, jt) if self._rl else _summary(st, batch, jt)
        if group is not None:
            summ = _all_gather_lanes(summ, group)
            ms = None if ms is None else _all_gather_lanes(ms, group)
        if self.telemetry:
            self.last_sweep_metrics = ms
        self._check_err(int(summ.err.max()))
        return (summ, ms) if with_metrics else summ

    def _shard_group(self, devices, T: int):
        """The process group whose ranks split the batch, or None for the
        unsharded sweep (see :meth:`sweep`)."""
        if isinstance(devices, DeviceMesh):
            if devices.ndim != 1:
                raise ValueError(f"sweep shards over a 1-D DeviceMesh; got "
                                 f"{devices.ndim} dims {devices.mesh_dim_names}")
            if devices.get_coordinate() is None:
                raise ValueError(f"rank {dist.get_rank()} is not in the sweep's mesh "
                                 f"{devices.mesh.tolist()}")
            here = (torch.device("cuda", torch.cuda.current_device())
                    if devices.device_type == "cuda" else torch.device(devices.device_type))
            if not same_device(here, self.device):
                raise ValueError(f"this rank's device of the mesh is {here}, the vectorized "
                                 f"engine's {self.device}: build each rank's engine on its "
                                 f"own device")
            return devices.get_group() if T % devices.size() == 0 else None
        n_dev = len(devices) if devices else 1
        if n_dev == 1 or T % n_dev:
            return None
        keys = [_device_key(d) for d in devices]
        if len(set(keys)) < len(keys):
            raise ValueError(f"sweep: devices {keys} list a device more than once")
        raise ValueError(f"sweep over {n_dev} devices: the port runs one process a device; "
                         f"shard the batch over a 1-D DeviceMesh (devices=mesh), whose every "
                         f"rank calls sweep")

    @staticmethod
    def _check_err(err: int) -> None:
        if err & ERR_READY_OVERFLOW:
            raise RuntimeError("vectorized engine: ready ring overflow")
        if err & ERR_EVENT_OVERFLOW:
            raise RuntimeError("vectorized engine: event-step budget exceeded (stuck trace?)")
        if err:
            raise RuntimeError(f"vectorized engine: error lanes {err:#x}")


def _device_key(d):
    """A device of a ``sweep(devices=[...])`` list as a hashable key: a
    ``torch.device`` (or its name) by its name, any other device object
    (a JAX device, say) as it is."""
    if isinstance(d, (str, torch.device)):
        return str(torch.device(d))
    return d


def _all_gather_lanes(tree, group):
    """A NamedTuple of lanes (leading axis ``k`` on each rank) with every
    rank's lanes of ``group``, in rank order (a collective)."""
    out = []
    for x in tree:
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        out.append(torch.cat(parts))
    return type(tree)(*out)


class VectorizedFleetSimulator:
    """Hash-routed fleet on the batched engine: one lane a pod.

    The hash router's assignment depends only on the binary, the seed and
    the static pod widths, never on cluster state, so the heap fleet under
    hash routing is exactly the merge of independent single-pod runs of
    the routed subtraces.  This wrapper splits the trace with the same
    :class:`~repro_torch.online.router.HashRouter` the heap uses, compiles
    each pod's subtrace against one shared job table, runs all pods as the
    lanes of one engine call with a per-lane ``width`` (a narrow pod's
    upper units are born busy), and merges the lanes back into one fleet
    :class:`~repro_torch.online.simulator.SimResult`.

    State-dependent routers (``least_loaded``/``frag``), ``mode="blocking"``
    and ticks raise, as in the reference.  With an RL policy,
    ``pod_params`` (a list of ``n_pods`` params dicts) overrides the
    agent's params per pod.  ``capacity`` bounds each pod's subtrace.
    """

    def __init__(self, policy=None, config: SimConfig | None = None, *, window: int = 8,
                 backfill: bool = True, capacity: int = 256,
                 pods: tuple[int, ...] | None = None, router: str = "hash",
                 router_seed: int = 0, telemetry: bool = False, pod_params: list | None = None,
                 device: str | torch.device = "cuda"):
        if config is None:
            config = SimConfig(window=window, backfill=backfill,
                               pods=tuple(pods) if pods is not None else (N_UNITS,),
                               router=router, router_seed=router_seed)
        if not self.supports(policy):
            raise ValueError(
                f"vectorized fleet serves TimeSharingPolicy or "
                f"RLDispatchPolicy plans; got {type(policy).__name__}")
        if config.router != "hash":
            raise ValueError(
                f"vectorized fleet requires the state-free 'hash' router "
                f"(got {config.router!r}); state-dependent routers couple "
                f"pods and run on the heap ClusterSimulator")
        if config.mode != "concurrent" or config.tick_interval_s:
            raise ValueError("vectorized fleet is concurrent-mode only, without ticks")
        self.config = config
        self.policy = policy if policy is not None else TimeSharingPolicy()
        self.capacity = capacity
        self.telemetry = telemetry
        self.device = torch.device(device)
        self.last_metrics: dict | None = None
        self._router = make_router(config.router, config.router_seed)
        self._rl = isinstance(self.policy, RLDispatchPolicy)
        if pod_params is not None:
            if not self._rl:
                raise ValueError("pod_params needs an RLDispatchPolicy")
            if len(pod_params) != config.n_pods:
                raise ValueError(f"pod_params has {len(pod_params)} entries for "
                                 f"{config.n_pods} pods")
        self.pod_params = pod_params
        if self._rl:
            env_cfg = self.policy.scheduler.env_cfg
            if config.window > env_cfg.window:
                raise ValueError(
                    f"sim window {config.window} > agent window "
                    f"{env_cfg.window}: use a sim window <= EnvConfig.window")
            _check_agent_device(self.policy, self.device)
            self._env_cfg = env_cfg
            self._parts = enumerate_partitions(env_cfg.c_max)
            self._runp = _build_run_rl(config.window, config.backfill, capacity, telemetry,
                                       env_cfg, device=self.device)
        else:
            self._runp = _build_run(config.window, config.backfill, capacity, telemetry)

    @staticmethod
    def supports(policy) -> bool:
        return VectorizedClusterSimulator.supports(policy)

    def run(self, trace: list[Arrival]) -> SimResult:
        cfg = self.config
        res = SimResult(policy=getattr(self.policy, "name", "time_sharing"),
                        window=cfg.window, jobs=[], mode="concurrent",
                        slice_busy_s=[0.0] * cfg.total_units, pods=cfg.pods, router=cfg.router)
        if not trace:
            return res
        order = sorted(trace, key=lambda a: a.t)
        records = [JobRecord(binary=a.binary, name=a.profile.name, arrival=a.t,
                             solo_time=a.profile.solo_time(), idx=i,
                             job_class=a.profile.job_class)
                   for i, a in enumerate(order)]
        res.jobs = records

        # static pre-split: the router the heap builds, fed a quiescent
        # FleetView (hash ignores the dynamic fields)
        view = FleetView(pods=tuple(
            PodView(idx=i, width=w, free=(True,) * w, pending=0, ready=0,
                    queue_units=0, busy_units=0)
            for i, w in enumerate(cfg.pods)))
        sub: list[list[Arrival]] = [[] for _ in cfg.pods]
        sub_rec: list[list[JobRecord]] = [[] for _ in cfg.pods]
        for a, rec in zip(order, records):
            p = 0 if cfg.n_pods == 1 else self._router.route(a, view)
            rec.pod = p
            sub[p].append(a)
            sub_rec[p].append(rec)

        names: dict[str, int] = {}
        jobs: list = []
        compiled = [compile_trace(s, self.capacity, names, jobs, device="cpu")[0] for s in sub]
        batch = stack_traces(compiled, self.device)
        widths = torch.tensor(cfg.pods, dtype=torch.int64, device=self.device)
        if self._rl:
            jt = build_rl_job_table(jobs, self.device)
            _check_agent_device(self.policy, self.device)
            params = (_stacked_params([{k: v.to(self.device) for k, v in p.items()}
                                       for p in self.pod_params])
                      if self.pod_params is not None else self.policy.agent.params)
            out = self._runp(batch, jt, params, widths)
        else:
            jt = build_job_table(jobs, self.device)
            out = self._runp(batch, jt, widths)
        if self.telemetry:
            sts, mss = out
            # pod lanes are disjoint sub-streams: fleet metrics are the sum
            self.last_metrics = metrics_dict(MetricsState(*(x.sum(dim=0) for x in mss)))
        else:
            sts = out
        lanes = _lanes_np(sts)
        VectorizedClusterSimulator._check_err(int(max(int(st.err) for st in lanes)))

        offs = res.pod_offsets
        segs: list[Segment] = []
        for p, (w, st) in enumerate(zip(cfg.pods, lanes)):
            if self._rl:
                segs.extend(_emit_lane_rl(st, jobs, self._parts, sub_rec[p], pod=p))
                res.refits += int(st.refits)
            else:
                segs.extend(_emit_lane(st, jt, sub_rec[p], pod=p))
            res.busy_time += float(st.busy_time)
            res.dispatches += int(st.dispatches)
            res.backfills += int(st.backfills)
            for u in range(w):
                res.slice_busy_s[offs[p] + u] = float(st.slice_busy[u])
        # merge lanes chronologically; the stable sort keeps each pod's
        # placement order on ties
        segs.sort(key=lambda s: (s.t0, s.pod))
        res.timeline = segs
        return res
