"""Batched torch mirror of the co-run performance model, for the vectorized
environment's close-group reward.

Port of ``repro/core/perfmodel_jax.py`` (this file is the port's
``perfmodel_vec``: the reference's module name says JAX, this one is
PyTorch).  Everything ``perfmodel.py`` computes per (group, partition) —
roofline terms, water-filled bandwidth contention, the phase simulation
over completion events — runs here as fixed-shape f32 tensor operations
over a **batch of groups at once**: every function takes a leading batch
axis B (one group per environment), and the per-slice simulation runs over
all (group, slice) pairs of the batch together.

The reference runs three ``lax.while_loop``s under ``vmap`` — the
water-fill (at most S rounds), the phase simulation (at most S completion
events) and the bandwidth fixed point (at most ``_FP_ITERS`` rounds) — so a
finished lane freezes while the others go on.  Here each loop runs to its
static bound with a per-lane ``running`` mask, and a lane whose loop has
ended keeps its values.  Nothing in a loop reads a value back to the host,
so a batch of groups costs a fixed number of launches and no device sync.

Two precomputed bundles (as in the reference):

  * ``PartitionTable`` — per ``EnvConfig``: slot -> (slice id, units,
    Level-2 share) for every partition of the curated table, padded to
    ``c_max`` slots.
  * ``QueueArrays``   — per queue: per-job roofline terms at every slice
    width, solo times, counter features and window means (a leading B axis
    once stacked).

The scalar float64 model (``perfmodel.py``) stays the reference;
``tests/test_torch_train.py`` holds this mirror to the JAX one.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.partition import N_UNITS, Partition, find_offsets, solo_partition
from repro_torch.core.perfmodel import KAPPA_INTERFERENCE, SIGMA_QUANTUM, corun
from repro_torch.core.profiles import FEATURES, JobProfile

UNIT_SIZES = (1, 2, 4, 8)            # valid slice widths (powers of two)
_FP_ITERS = 30                       # perfmodel fixed-point iteration budget


class PartitionTable(NamedTuple):
    """Curated partition table flattened to padded per-slot tensors."""

    slot_valid: torch.Tensor         # (P, S) bool — slot exists
    slot_slice: torch.Tensor         # (P, S) int64 — slice id within partition
    slot_units_idx: torch.Tensor     # (P, S) int64 — index into UNIT_SIZES
    slot_units: torch.Tensor         # (P, S) f32 — slice width in units
    slot_beta: torch.Tensor          # (P, S) f32 — Level-2 compute share
    slice_shared: torch.Tensor       # (P, S) bool — slice id s holds >1 share
    arity: torch.Tensor              # (P,) int64


class QueueArrays(NamedTuple):
    """Per-queue job terms; the leading axis is the (padded) window slot,
    after :func:`stack_queues` a batch axis before it."""

    features: torch.Tensor           # (W, F) f32 — paper counter features
    valid: torch.Tensor              # (W,) bool — real job (not padding)
    comp: torch.Tensor               # (W, U) f32 — compute seconds/step
    mem: torch.Tensor                # (W, U) f32 — HBM seconds/step
    collb: torch.Tensor              # (W, U) f32 — collective-bytes seconds
    colll: torch.Tensor              # (W, U) f32 — collective latency chain
    fixedt: torch.Tensor             # (W, U) f32 — fixed + serial seconds
    steps: torch.Tensor              # (W,) f32 — job length in steps
    solo: torch.Tensor               # (W,) f32 — SoloRunTime
    cpct: torch.Tensor               # (W,) f32 — Compute (SM) [%]
    mpct: torch.Tensor               # (W,) f32 — Memory [%]
    mean_c: torch.Tensor             # () f32 — window mean of cpct
    mean_m: torch.Tensor             # () f32 — window mean of mpct
    mean_d: torch.Tensor             # () f32 — window mean of solo


def build_partition_table(partitions: list[Partition], c_max: int,
                          device: str | torch.device = "cuda") -> PartitionTable:
    P, S = len(partitions), c_max
    valid = np.zeros((P, S), bool)
    slot_slice = np.zeros((P, S), np.int64)
    units_idx = np.zeros((P, S), np.int64)
    units = np.ones((P, S), np.float32)
    beta = np.ones((P, S), np.float32)
    shared = np.zeros((P, S), bool)
    arity = np.zeros((P,), np.int64)
    for p_i, p in enumerate(partitions):
        arity[p_i] = p.arity
        for k, (si, s, b) in enumerate(p.slots):
            valid[p_i, k] = True
            slot_slice[p_i, k] = si
            units_idx[p_i, k] = UNIT_SIZES.index(s.units)
            units[p_i, k] = s.units
            beta[p_i, k] = b
        for si, s in enumerate(p.slices):
            shared[p_i, si] = len(s.shares) > 1
    return PartitionTable(*(torch.as_tensor(a, device=device) for a in
                            (valid, slot_slice, units_idx, units, beta, shared, arity)))


def _job_rows(jobs: list[JobProfile], n_rows: int) -> dict:
    """Numpy job terms for ``jobs`` in rows ``0..len(jobs)-1`` of ``n_rows``;
    the other rows hold the padding values (``fixedt = 1``, ``steps = 1``,
    everything else 0)."""
    U, F = len(UNIT_SIZES), len(FEATURES)
    out = {"features": np.zeros((n_rows, F), np.float32)}
    for k in ("comp", "mem", "collb", "colll"):
        out[k] = np.zeros((n_rows, U), np.float32)
    out["fixedt"] = np.ones((n_rows, U), np.float32)     # harmless nonzero for padding
    out["steps"] = np.ones((n_rows,), np.float32)
    for k in ("solo", "cpct", "mpct"):
        out[k] = np.zeros((n_rows,), np.float32)
    for i, j in enumerate(jobs):
        out["features"][i] = j.features()
        for u_i, u in enumerate(UNIT_SIZES):
            c, m, x = j.terms(u)      # torus factor defaults to the slice's
            out["comp"][i, u_i], out["mem"][i, u_i], out["collb"][i, u_i] = c, m, x
            out["colll"][i, u_i] = j.coll_latency(u)
            out["fixedt"][i, u_i] = j.fixed_latency(u) + j.serial_s
        out["steps"][i] = j.steps
        out["solo"][i] = j.solo_time()
        out["cpct"][i] = j.compute_pct
        out["mpct"][i] = j.memory_pct
    return out


def queue_arrays(queue: list[JobProfile], window: int,
                 device: str | torch.device = "cuda") -> QueueArrays:
    """Precompute all job terms the reward needs (numpy, once per queue)."""
    assert len(queue) <= window, (len(queue), window)
    rows = _job_rows(queue, window)
    valid = np.zeros((window,), bool)
    valid[:len(queue)] = True
    n = max(1, len(queue))
    means = {k: np.float32(rows[src][:len(queue)].sum() / n)
             for k, src in (("mean_c", "cpct"), ("mean_m", "mpct"), ("mean_d", "solo"))}
    fields = dict(rows, valid=valid, **means)
    return QueueArrays(**{k: torch.as_tensor(fields[k], device=device)
                          for k in QueueArrays._fields})


def stack_queues(qas: list[QueueArrays]) -> QueueArrays:
    """Batch per-queue arrays along a new leading axis."""
    return QueueArrays(*(torch.stack(xs) for xs in zip(*qas)))


class JobTermsTable(NamedTuple):
    """Per-*job* roofline terms, gatherable into window ``QueueArrays``.

    Row ``J`` (one past the last job) is the padding row — the values
    ``queue_arrays`` writes for empty slots, so a gather of the padding
    index reproduces a padded window slot bit for bit."""

    features: torch.Tensor           # (J+1, F) f32
    comp: torch.Tensor               # (J+1, U) f32
    mem: torch.Tensor                # (J+1, U) f32
    collb: torch.Tensor              # (J+1, U) f32
    colll: torch.Tensor              # (J+1, U) f32
    fixedt: torch.Tensor             # (J+1, U) f32
    steps: torch.Tensor              # (J+1,) f32
    solo: torch.Tensor               # (J+1,) f32
    cpct: torch.Tensor               # (J+1,) f32
    mpct: torch.Tensor               # (J+1,) f32


def job_terms_table(jobs: list[JobProfile],
                    device: str | torch.device = "cuda") -> JobTermsTable:
    """Precompute :class:`JobTermsTable` rows for ``jobs`` (+ padding row)."""
    rows = _job_rows(jobs, len(jobs) + 1)
    return JobTermsTable(**{k: torch.as_tensor(rows[k], device=device)
                            for k in JobTermsTable._fields})


def build_fit_table(partitions: list[Partition],
                    device: str | torch.device = "cuda") -> torch.Tensor:
    """(P, 2**N_UNITS) f32 — does partition ``p`` first-fit busy mask ``m``?

    ``fit[p, m] = 1.0`` iff :func:`~repro_torch.core.partition.find_offsets`
    places every slice of partition ``p`` onto the free units of mask ``m``
    (bit u of ``m`` set = unit u busy)."""
    P, M = len(partitions), 1 << N_UNITS
    fits = np.zeros((P, M), np.float32)
    for p_i, p in enumerate(partitions):
        for m in range(M):
            free = [not (m >> u) & 1 for u in range(N_UNITS)]
            if find_offsets(p, free) is not None:
                fits[p_i, m] = 1.0
    return torch.as_tensor(fits, device=device)


# ---------------------------------------------------------------------------
# water-filling + phase simulation (batched mirrors of perfmodel.py)
# ---------------------------------------------------------------------------

def water_fill_vec(demands: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """``perfmodel.water_fill`` over the last axis (S lanes) of every row,
    with an active mask.

    Each round sates at least one lane or ends the row, so S rounds reach
    every row's end; a row that has ended (no active lane, or the capacity
    spent) is masked out of the later rounds (``live``).  A lane still
    active has received nothing yet, so its unmet demand is its demand: a
    sated lane gets its demand, and the lanes left when a round sates none
    share what remains (``level``) — the reference's allocation, from the
    same f32 operations."""
    remaining = torch.ones(demands.shape[:-1] + (1,), dtype=demands.dtype,
                           device=demands.device)
    level = torch.zeros_like(remaining)
    act = active
    for _ in range(demands.shape[-1]):
        n = act.sum(dim=-1, keepdim=True)
        live = (n > 0) & (remaining > 1e-12)
        fair = remaining / n.clamp_min(1)
        sated = act & live & (demands <= fair + 1e-15)
        any_sated = sated.any(dim=-1, keepdim=True)
        deficit = torch.where(sated, demands, 0.0).sum(dim=-1, keepdim=True)
        remaining = torch.where(any_sated, remaining - deficit, 0.0)
        level = torch.where(live & ~any_sated, fair, level)
        act = act & ~sated
    return torch.where(act, level, torch.where(active, demands, 0.0))


def _slice_step_times(c, m, xb, xl, fx, active, shared_flag):
    """Per-step times of the active co-residents of each slice: rows (N, S)
    of S lanes, ``shared_flag`` (N,).

    The memory and collective bandwidths are water-filled together (a
    (N, 2, S) stack), and the fixed point runs ``_FP_ITERS`` rounds; a row
    whose last round moved its targets by less than 1e-9 keeps its values."""
    n_active = active.sum(dim=-1)
    multi = n_active > 1
    shared_mem = shared_flag & multi
    demand_num = torch.stack([m, xb], dim=1)                 # (N, 2, S): m, xb
    use_flag = torch.stack([shared_mem, multi], dim=1)[:, :, None]
    act2 = active[:, None, :].expand_as(demand_num)
    t_mx = demand_num                                        # mem_t, coll_t
    u_mx = torch.zeros_like(demand_num)                      # mem_u, coll_u
    running = torch.ones_like(multi)
    for _ in range(_FP_ITERS):
        st = torch.maximum(torch.maximum(c, t_mx[:, 0]), t_mx[:, 1] + xl) + fx
        u = torch.clamp_max(demand_num / st[:, None, :], 1.0)
        alloc = water_fill_vec(u, act2)
        use = use_flag & (alloc > 1e-12) & (u > alloc + 1e-12)
        tgt = torch.where(use, demand_num / alloc.clamp_min(1e-30), demand_num)
        step = tgt - t_mx
        diff = step.abs()
        delta = torch.where(active, diff[:, 0] + diff[:, 1], 0.0).sum(dim=-1)
        run3 = running[:, None, None]
        t_mx = torch.where(run3, t_mx + 0.5 * step, t_mx)
        u_mx = torch.where(run3, u, u_mx)
        running = running & (delta >= 1e-9)
    mem_t, coll_t = t_mx[:, 0], t_mx[:, 1]
    mem_u, coll_u = u_mx[:, 0], u_mx[:, 1]
    sum_mu = torch.where(active, mem_u, 0.0).sum(dim=-1, keepdim=True)
    sum_cu = torch.where(active, coll_u, 0.0).sum(dim=-1, keepdim=True)
    km = torch.where(shared_mem[:, None], 1.0 + KAPPA_INTERFERENCE * (sum_mu - mem_u), 1.0)
    kx = torch.where(multi[:, None], 1.0 + KAPPA_INTERFERENCE * (sum_cu - coll_u), 1.0)
    t = torch.maximum(torch.maximum(c, mem_t * km), (coll_t + xl) * kx) + fx
    quantum = torch.where(multi, 1.0 + SIGMA_QUANTUM * (n_active - 1), 1.0)
    return t * quantum[:, None]


def _simulate_slice(c, m, xb, xl, fx, steps, members, shared_flag):
    """Phase simulation of each slice (rows (N, S)) -> per-lane finish times.

    Completion is detected both by remaining-work underflow (the Python
    criterion, too strict in f32) and by reaching the phase's minimum finish
    time, so the argmin job always completes its phase.  A row with no active
    lane left changes nothing but its clock, which no lane reads again."""
    remaining = torch.where(members, steps, 0.0)
    active = members
    t = torch.zeros_like(steps[:, :1])
    finish = torch.zeros_like(steps)
    for _ in range(steps.shape[-1]):
        st = _slice_step_times(c, m, xb, xl, fx, active, shared_flag)
        tt = torch.where(active, remaining * st, torch.inf)
        dt = tt.min(dim=-1, keepdim=True).values
        new_rem = torch.where(active, remaining - dt / st, remaining)
        done_now = active & ((new_rem <= 1e-9) | (tt <= dt * (1.0 + 1e-6)))
        finish = torch.where(done_now, t + dt, finish)
        remaining, active, t = new_rem, active & ~done_now, t + dt
    return finish


def group_metrics(table: PartitionTable, qa: QueueArrays, group_idx: torch.Tensor,
                  group_size: torch.Tensor, p_idx: torch.Tensor,
                  units_idx: torch.Tensor | None = None, with_finish: bool = False):
    """(co-run makespan, Σ solo time, Σ r_i), each (B,), for B groups at once.

    ``qa`` is stacked (leading axis B), ``group_idx`` (B, S) holds window
    slots in selection order, ``group_size`` (B,), ``p_idx`` (B,) the
    partition of each group.  ``units_idx`` (B, S) overrides the planned slot
    widths for the roofline terms only (the placement layer's right-sizing,
    as in the reference).  ``with_finish=True`` also returns the per-slot
    finish times (B, S)."""
    B, S = group_idx.shape
    W = qa.steps.shape[-1]
    dev = group_idx.device
    lanes = torch.arange(S, device=dev)
    slot_ok = table.slot_valid[p_idx] & (lanes[None, :] < group_size[:, None])
    j = group_idx.clamp(0, W - 1)
    u = table.slot_units_idx[p_idx] if units_idx is None else units_idx
    beta = table.slot_beta[p_idx]
    bi = torch.arange(B, device=dev)[:, None]
    c = qa.comp[bi, j, u] / beta
    m, xb, xl, fx = qa.mem[bi, j, u], qa.collb[bi, j, u], qa.colll[bi, j, u], qa.fixedt[bi, j, u]
    steps = qa.steps[bi, j]
    sl = table.slot_slice[p_idx]
    # one row per (group, slice id): its members are the group's slots on it
    members = slot_ok[:, None, :] & (sl[:, None, :] == lanes[None, :, None])   # (B, S, S)

    def rows(x):
        return x[:, None, :].expand(B, S, S).reshape(B * S, S)

    f = _simulate_slice(rows(c), rows(m), rows(xb), rows(xl), rows(fx), rows(steps),
                        members.reshape(B * S, S),
                        table.slice_shared[p_idx].reshape(B * S)).reshape(B, S, S)
    finish = torch.where(members, f, 0.0).sum(dim=1)     # each slot sits on one slice
    makespan = torch.where(slot_ok, finish, 0.0).amax(dim=-1)
    solo_j = qa.solo[bi, j]
    solo = torch.where(slot_ok, solo_j, 0.0).sum(dim=-1)
    units = table.slot_units[p_idx]
    sm_alloc = (units / N_UNITS) * beta
    mem_alloc = units / N_UNITS
    cr = qa.cpct[bi, j] / qa.mean_c.clamp_min(1e-9)[:, None]
    mr = qa.mpct[bi, j] / qa.mean_m.clamp_min(1e-9)[:, None]
    dr = solo_j / qa.mean_d.clamp_min(1e-9)[:, None]
    ri = (sm_alloc * cr + mem_alloc * mr) * dr ** 2
    ri_sum = torch.where(slot_ok, ri, 0.0).sum(dim=-1)
    if with_finish:
        return makespan, solo, ri_sum, torch.where(slot_ok, finish, 0.0)
    return makespan, solo, ri_sum


class GraphedGroupMetrics:
    """:func:`group_metrics` for tensors on the card, replayed from a CUDA
    graph.

    The fixed point, the phase simulation and the water-fill are some ten
    thousand small kernels per call, so on the card a call is bound by the
    host's launch rate, not by the device.  The first call at a given shape
    (and ``units_idx`` / ``with_finish`` form) captures the whole sequence
    once; every later call copies its inputs into the graph's buffers and
    replays it — the same kernels on the same values, launched by one host
    call.  The queue arrays are copied only when they are other tensors
    than the last call's (they are fixed through a training segment).
    ``replays`` counts replays."""

    def __init__(self, table: PartitionTable):
        self.table = table
        self._graphs: dict = {}
        self.replays = 0

    def _capture(self, qa, args, with_finish):
        static = (QueueArrays(*(x.clone() for x in qa)),) + tuple(a.clone() for a in args)

        def call():
            s_qa, idx, size, p, *units = static
            return group_metrics(self.table, s_qa, idx, size, p,
                                 units_idx=units[0] if units else None, with_finish=with_finish)

        with torch.cuda.device(args[0].device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):             # warm-up off the capture
                call()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = call()
        return {"graph": graph, "static": static, "out": out, "qa": None}

    def __call__(self, qa: QueueArrays, group_idx: torch.Tensor, group_size: torch.Tensor,
                 p_idx: torch.Tensor, units_idx: torch.Tensor | None = None,
                 with_finish: bool = False):
        args = (group_idx, group_size, p_idx) + (() if units_idx is None else (units_idx,))
        key = (tuple(group_idx.shape), tuple(qa.comp.shape), group_idx.device,
               units_idx is None, with_finish)
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._graphs[key] = self._capture(qa, args, with_finish)
        s_qa, *s_args = entry["static"]
        if entry["qa"] is None or any(a is not b for a, b in zip(entry["qa"], qa)):
            for dst, src in zip(s_qa, qa):
                dst.copy_(src)
            entry["qa"] = qa
        for dst, src in zip(s_args, args):
            dst.copy_(src)
        entry["graph"].replay()
        self.replays += 1
        return tuple(x.clone() for x in entry["out"])


def solo_duration_table(jobs: list[JobProfile]) -> np.ndarray:
    """``(J, len(UNIT_SIZES))`` float64 solo makespans per (job, width), on
    the host through the float64 reference model (copied)."""
    out = np.zeros((len(jobs), len(UNIT_SIZES)), np.float64)
    for i, job in enumerate(jobs):
        for u, w in enumerate(UNIT_SIZES):
            out[i, u] = corun([job], solo_partition(w)).makespan
    return out


def close_reward(makespan: torch.Tensor, solo: torch.Tensor, ri: torch.Tensor,
                 r_i_weight: float, r_f_scale: float) -> torch.Tensor:
    """Paper Table VI close-group reward from :func:`group_metrics`' outputs."""
    rf = torch.where(makespan > 0,
                     (solo / makespan.clamp_min(1e-30) - 1.0) * r_f_scale, 0.0)
    return r_i_weight * ri + rf


def group_reward(table: PartitionTable, qa: QueueArrays, group_idx: torch.Tensor,
                 group_size: torch.Tensor, p_idx: torch.Tensor, r_i_weight: float,
                 r_f_scale: float) -> torch.Tensor:
    """Paper Table VI close-group reward: r_i_weight * Σ r_i + r_f, (B,)."""
    makespan, solo, ri = group_metrics(table, qa, group_idx, group_size, p_idx)
    return close_reward(makespan, solo, ri, r_i_weight, r_f_scale)
