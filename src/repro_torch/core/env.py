"""RL environment for co-scheduling + hierarchical partitioning (paper §IV-C).

Port of ``repro/core/env.py``: the configuration, the arrival-aware
context helpers, and the environment's two implementations:

  * :class:`VecCoScheduleEnv` — the functional core, batched over B
    environments on a device: an immutable :class:`EnvState` of tensors and
    pure ``reset_batch`` / ``step_batch`` transitions whose close rewards
    come from the batched perfmodel (:mod:`repro_torch.core.perfmodel_vec`).
    The training loop (``train.py``) steps B episodes at once through it.
  * :class:`CoScheduleEnv` — the stateful reference wrapper ``RLScheduler``
    steps, numpy and the float64 Python perfmodel on the host.

State: W slots x (f profile features + 5 status flags), flattened — the
paper's input layer ``W x (f+5)`` — plus, with ``EnvConfig.obs_context``,
the busy-unit mask, per-slot queueing ages and pending depth
(``docs/observation.md``).  Actions: W *select-job-i into the current group*
+ N_p *close the group with partition p*.  Rewards (paper Table VI):
    on close:  Σ_j r_i(j)  +  r_f = (SoloRunTime/CoRunTime - 1) x 100
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.partition import (
    N_UNITS, Partition, aligned_offsets, enumerate_partitions, find_offsets,
)
from repro_torch.core.perfmodel import corun_time, solo_run_time
from repro_torch.core.perfmodel_vec import (
    GraphedGroupMetrics, PartitionTable, QueueArrays, build_fit_table, build_partition_table,
    close_reward, group_metrics, queue_arrays, stack_queues,
)
from repro_torch.core.problem import Schedule
from repro_torch.core.profiles import FEATURES, JobProfile

N_FLAGS = 5  # available, in-group, scheduled, padding, group-progress


@dataclass
class EnvConfig:
    window: int = 12                     # W
    c_max: int = 4                       # Cmax
    r_f_scale: float = 100.0             # paper: x100
    r_i_weight: float = 0.2              # r_f carries the true objective
    invalid_penalty: float = -10.0       # masked anyway; safety net
    obs_context: bool = False            # append the arrival-aware block
    ctx_fit_weight: float = 10.0         # close-shaping when the partition
                                         # can't fit the observed free units
                                         # (active only under obs_context)

    def key(self) -> tuple:
        """Hashable identity (EnvConfig is mutable; used for engine caches).
        Derived from the declared fields so it can never go stale."""
        import dataclasses

        return tuple(getattr(self, f.name) for f in dataclasses.fields(self))


def context_dim(cfg: EnvConfig) -> int:
    """Width of the appended context block: busy mask + per-slot ages + depth."""
    return (N_UNITS + cfg.window + 1) if cfg.obs_context else 0


def age_feature(age_s: float) -> float:
    """Queueing age -> feature: log10 compression on the same 1e6-second
    scale as the profile features' ``log_duration`` (docs/observation.md)."""
    return math.log10(1.0 + max(age_s, 0.0)) / 6.0


def depth_feature(depth: int, window: int) -> float:
    """Pending-queue depth -> feature: saturating at 4 windows' worth."""
    return min(depth / (4.0 * window), 1.0)


@dataclass(frozen=True)
class DispatchContext:
    """Cluster-state snapshot the online dispatch layer hands the planner.

    Built by the online simulator at every dispatch window and threaded through ``submission_protocol`` down to
    ``RLScheduler.schedule``; the environment normalizes it into the
    observation's context block (:func:`dispatch_obs_context`).
    """

    free_units: tuple[bool, ...]         # (N_UNITS,) True = idle slice unit
    ages_s: tuple[float, ...]            # per-submission wait so far, seconds
    queue_depth: int = 0                 # pending submissions beyond this window
    now_s: float = 0.0                   # simulated dispatch instant


class ObsContext(NamedTuple):
    """Normalized context block appended to the observation (f32 numpy
    arrays in the scalar env, batched device tensors in the vectorized one).

    The zero context — empty pod, no queued work, fresh arrivals — is the
    parity anchor: with ``ObsContext`` all-zero the observation prefix
    matches the profile-only layout.  ``busy_units`` is stored busy-high
    (1 = claimed), so "all zeros" means "everything free".
    """

    busy_units: np.ndarray               # (N_UNITS,) f32 — 1 = unit claimed
    ages: np.ndarray                     # (W,) f32 — age_feature per slot
    queue_depth: np.ndarray              # () f32 — depth_feature


def zero_context(window: int) -> ObsContext:
    """The neutral (empty-cluster) context — the offline/parity default."""
    return ObsContext(
        busy_units=np.zeros((N_UNITS,), np.float32),
        ages=np.zeros((window,), np.float32),
        queue_depth=np.zeros((), np.float32),
    )


def dispatch_obs_context(ctx: DispatchContext, window: int) -> ObsContext:
    """Normalize a simulator snapshot into the observation's context block."""
    busy = np.asarray([0.0 if f else 1.0 for f in ctx.free_units], np.float32)
    assert busy.shape == (N_UNITS,), ctx.free_units
    ages = np.zeros((window,), np.float32)
    for i, a in enumerate(ctx.ages_s[:window]):
        ages[i] = age_feature(a)
    return ObsContext(
        busy_units=busy, ages=ages,
        queue_depth=np.float32(depth_feature(ctx.queue_depth, window)),
    )


_N_CTX_MASKS = 64


def _context_mask_table(n_masks: int = _N_CTX_MASKS, seed: int = 0) -> np.ndarray:
    """(K, N_UNITS) f32 — plausible busy masks for training-time sampling.

    Each row is a union of buddy-aligned block claims (the only shapes the
    slice-level dispatcher ever produces) at a uniformly drawn fill target.
    Row 0 is the all-free pod.  Fixed seed: the table is part of the
    engine's deterministic identity (copied from the reference, numpy)."""
    rng = np.random.default_rng(seed)
    out = np.zeros((n_masks, N_UNITS), np.float32)
    for i in range(1, n_masks):
        target = rng.uniform()
        busy = np.zeros(N_UNITS, bool)
        for _ in range(16):
            if busy.mean() >= target:
                break
            w = int(rng.choice((1, 2, 4, 8), p=(0.4, 0.3, 0.2, 0.1)))
            off = int(rng.choice(aligned_offsets(w)))
            if not busy[off:off + w].any():
                busy[off:off + w] = True
        out[i] = busy
    return out


class EnvState(NamedTuple):
    """A batch of B episode states (device tensors); ``queue`` is constant
    through an episode.  ``ctx`` is carried even when ``obs_context=False``,
    where it is all-zero and never read — one layout for both modes."""

    queue: QueueArrays                   # stacked per-queue job arrays, (B, ...)
    scheduled: torch.Tensor              # (B, W) bool
    group_idx: torch.Tensor              # (B, c_max) int64, selection order, -1 pad
    group_size: torch.Tensor             # (B,) int64
    ctx: ObsContext                      # (B, N_UNITS), (B, W), (B,) f32


class VecCoScheduleEnv:
    """Batched functional environment on a device.

    ``reset_batch(queue_arrays)`` and ``step_batch(state, action)`` are pure
    functions of their inputs over a leading env axis B — all change is in
    the returned :class:`EnvState`.  The reference's single-env ``reset`` /
    ``step`` are these with B = 1.  Rewards come from the batched perfmodel
    (:mod:`repro_torch.core.perfmodel_vec`), one launch sequence for the
    whole batch and no host sync.
    """

    def __init__(self, cfg: EnvConfig | None = None, device: str | torch.device = "cuda"):
        self.cfg = cfg or EnvConfig()
        self.device = torch.device(device)
        self.partitions: list[Partition] = enumerate_partitions(self.cfg.c_max)
        self.table: PartitionTable = build_partition_table(
            self.partitions, self.cfg.c_max, self.device)
        # the perfmodel's launches replay from a CUDA graph on the card
        if self.device.type == "cuda":
            self._metrics = GraphedGroupMetrics(self.table)
        else:
            self._metrics = functools.partial(group_metrics, self.table)
        self.n_features = len(FEATURES)
        self.context_dim = context_dim(self.cfg)
        self.state_dim = (self.cfg.window * (self.n_features + N_FLAGS)
                          + self.context_dim)
        self.n_actions = self.cfg.window + len(self.partitions)
        self._slots = torch.arange(self.cfg.window, device=self.device)
        self._lanes = torch.arange(self.cfg.c_max, device=self.device)
        if self.cfg.obs_context:
            # partition-vs-busy-mask fit table (close shaping) + the sampled
            # occupancy distribution offline training draws contexts from
            self._fit_table = build_fit_table(self.partitions, self.device)
            self._ctx_masks = torch.as_tensor(_context_mask_table(), device=self.device)
            self._pow2 = 2 ** torch.arange(N_UNITS, device=self.device)

    # ----------------------------------------------------------- queue prep
    def queue_arrays(self, queue: list[JobProfile]) -> QueueArrays:
        return queue_arrays(queue, self.cfg.window, self.device)

    def queue_batch(self, queues: list[list[JobProfile]]) -> QueueArrays:
        return stack_queues([self.queue_arrays(q) for q in queues])

    def zero_context_batch(self, n: int) -> ObsContext:
        """The neutral context for n envs."""
        def z(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=self.device)

        return ObsContext(busy_units=z(n, N_UNITS), ages=z(n, self.cfg.window),
                          queue_depth=z(n))

    # ------------------------------------------------------------ functions
    def reset_batch_ctx(self, qa: QueueArrays, ctx: ObsContext):
        n = qa.valid.shape[0]
        state = EnvState(
            queue=qa,
            scheduled=torch.zeros((n, self.cfg.window), dtype=torch.bool, device=self.device),
            group_idx=torch.full((n, self.cfg.c_max), -1, dtype=torch.int64, device=self.device),
            group_size=torch.zeros((n,), dtype=torch.int64, device=self.device),
            ctx=ctx,
        )
        return state, self.obs_batch(state), self._mask(state)

    def reset_batch(self, qa: QueueArrays):
        """Reset with the neutral zero context — the profile-only default."""
        return self.reset_batch_ctx(qa, self.zero_context_batch(qa.valid.shape[0]))

    def sample_context(self, generator: torch.Generator | None, mean_d: torch.Tensor,
                       valid: torch.Tensor, draws=None) -> ObsContext:
        """Batched training-time context draw (requires ``obs_context``).

        ``mean_d`` (B,) is each queue's mean solo duration — the scale of the
        queueing-age draws — and ``valid`` (B, W) masks padding slots to zero
        age.  Busy masks come from the aligned-claim table, ages from an
        exponential wait model, queue depth from an exponential with mean one
        window: the normalizations of :func:`dispatch_obs_context`.  The
        random numbers are ``draws = (mask_index (B,), age_exp (B, W),
        depth_exp (B,))`` (standard exponentials) when given, else drawn from
        ``generator``."""
        B = valid.shape[0]
        if draws is None:
            idx = torch.randint(0, self._ctx_masks.shape[0], (B,), generator=generator,
                                device=self.device)
            raw_e = torch.empty(valid.shape, device=self.device).exponential_(
                generator=generator)
            dep_e = torch.empty((B,), device=self.device).exponential_(generator=generator)
        else:
            idx, raw_e, dep_e = (torch.as_tensor(x, device=self.device) for x in draws)
        raw = raw_e.float() * mean_d[:, None]
        return ObsContext(
            busy_units=self._ctx_masks[idx.long()],
            ages=torch.where(valid, torch.log10(1.0 + raw) / 6.0, 0.0),
            queue_depth=torch.clamp_max(dep_e.float() / 4.0, 1.0),
        )

    def _member(self, state: EnvState) -> torch.Tensor:
        """(B, W) bool — job i currently selected into the open group."""
        live = self._lanes[None, :] < state.group_size[:, None]             # (B, c)
        hits = state.group_idx[:, None, :] == self._slots[None, :, None]     # (B, W, c)
        return (hits & live[:, None, :]).any(dim=-1)

    def obs_batch(self, state: EnvState) -> torch.Tensor:
        member = self._member(state)
        valid = state.queue.valid
        progress = state.group_size.float() / max(1, self.cfg.c_max)
        flags = torch.stack([
            (valid & ~state.scheduled & ~member).float(),
            member.float(),
            (state.scheduled & valid).float(),
            (~valid).float(),
            torch.where(valid, progress[:, None], 0.0),
        ], dim=-1)
        flat = torch.cat([state.queue.features, flags], dim=-1).flatten(1)
        if not self.cfg.obs_context:
            return flat
        return torch.cat([flat, state.ctx.busy_units, state.ctx.ages,
                          state.ctx.queue_depth[:, None]], dim=1)

    def _mask(self, state: EnvState) -> torch.Tensor:
        member = self._member(state)
        can_select = (state.queue.valid & ~state.scheduled & ~member
                      & (state.group_size < self.cfg.c_max)[:, None])
        can_close = ((state.group_size >= 1)[:, None]
                     & (self.table.arity[None, :] == state.group_size[:, None]))
        return torch.cat([can_select, can_close], dim=1)

    def _done(self, state: EnvState) -> torch.Tensor:
        return ((state.scheduled | ~state.queue.valid).all(dim=1)
                & (state.group_size == 0))

    def step_batch(self, state: EnvState, action: torch.Tensor, with_metrics: bool = False):
        """Pure transition -> (state', obs', reward, done, mask').

        ``with_metrics=True`` appends what :meth:`close_metrics_batch` returns
        for the same state and action, from the same perfmodel call."""
        W = self.cfg.window
        action = action.long()
        mask = self._mask(state)
        valid = mask.gather(1, action[:, None])[:, 0]
        is_select = action < W
        take_sel, take_close = valid & is_select, valid & ~is_select
        # close branch: score the group under partition p
        p_idx = (action - W).clamp(0, len(self.partitions) - 1)
        mk, so, ri = self._metrics(state.queue, state.group_idx, state.group_size, p_idx)
        r_close = close_reward(mk, so, ri, self.cfg.r_i_weight, self.cfg.r_f_scale)
        if self.cfg.obs_context and self.cfg.ctx_fit_weight > 0:
            # closing onto a partition that cannot first-fit the observed free
            # units costs ctx_fit_weight; an exact 0 at zero context
            m_idx = torch.where(state.ctx.busy_units > 0.5, self._pow2, 0).sum(dim=-1)
            r_close = r_close - self.cfg.ctx_fit_weight * (
                1.0 - self._fit_table[p_idx, m_idx])
        # select branch: append to the open group (selection order kept); a
        # full group's select is invalid, so its clamped write is never kept
        slot = state.group_size.clamp_max(self.cfg.c_max - 1)[:, None]
        sel_idx = state.group_idx.scatter(1, slot, action[:, None])
        new_state = state._replace(
            scheduled=torch.where(take_close[:, None], state.scheduled | self._member(state),
                                  state.scheduled),
            group_idx=torch.where(take_sel[:, None], sel_idx,
                                  torch.where(take_close[:, None], -1, state.group_idx)),
            group_size=torch.where(take_sel, state.group_size + 1,
                                   torch.where(take_close, 0, state.group_size)),
        )
        reward = torch.where(valid, torch.where(is_select, 0.0, r_close),
                             self.cfg.invalid_penalty)
        out = (new_state, self.obs_batch(new_state), reward, self._done(new_state),
               self._mask(new_state))
        if with_metrics:
            zero = torch.zeros_like(mk)
            out += (torch.where(take_close, mk, zero), torch.where(take_close, so, zero),
                    take_close & (state.group_size > 1))
        return out

    def close_metrics_batch(self, state: EnvState, action: torch.Tensor):
        """(co-run time, solo time, multi-job?) the close ``action`` realizes,
        each (B,); zeros where ``action`` is not a valid close."""
        W = self.cfg.window
        action = action.long()
        ok = self._mask(state).gather(1, action[:, None])[:, 0] & (action >= W)
        p_idx = (action - W).clamp(0, len(self.partitions) - 1)
        mk, so, _ = self._metrics(state.queue, state.group_idx, state.group_size, p_idx)
        zero = torch.zeros_like(mk)
        return (torch.where(ok, mk, zero), torch.where(ok, so, zero),
                ok & (state.group_size > 1))


class CoScheduleEnv:
    """Gym-style (reset/step) reference wrapper, dependency-free.

    Thin stateful shell over the same action/observation contract as the
    functional core, kept for the scheduler/baselines API.  Rewards use the
    float64 Python perfmodel; it also materializes the
    :class:`Schedule` object the online phase consumes.
    """

    def __init__(self, cfg: EnvConfig | None = None):
        self.cfg = cfg or EnvConfig()
        self.partitions: list[Partition] = enumerate_partitions(self.cfg.c_max)
        self.n_features = len(FEATURES)
        self.context_dim = context_dim(self.cfg)
        self.state_dim = (self.cfg.window * (self.n_features + N_FLAGS)
                          + self.context_dim)
        self.n_actions = self.cfg.window + len(self.partitions)
        self._queue: list[JobProfile] = []
        self._ctx: DispatchContext | None = None

    # ------------------------------------------------------------------ API
    def reset(self, queue: list[JobProfile],
              context: DispatchContext | None = None) -> tuple[np.ndarray, np.ndarray]:
        """``context`` is the dispatch-time cluster snapshot (ignored unless
        ``cfg.obs_context``); ``None`` is the neutral zero context."""
        assert len(queue) <= self.cfg.window
        if context is not None and self.cfg.obs_context:
            assert len(context.ages_s) == len(queue), \
                (len(context.ages_s), len(queue))
        self._queue = list(queue)
        self._ctx = context
        self._scheduled = [False] * len(queue)
        self._in_group: list[int] = []           # selection-ordered indices
        self.schedule = Schedule()
        return self._state(), self.action_mask()

    def step(self, action: int):
        W = self.cfg.window
        reward = 0.0
        if not self._valid(action):
            return self._state(), self.cfg.invalid_penalty, self.done, self.action_mask(), {}
        if action < W:
            self._in_group.append(action)
        else:
            partition = self.partitions[action - W]
            group = [self._queue[i] for i in self._in_group]
            reward = self._close_reward(group, partition)
            self.schedule.add(group, partition)
            for i in self._in_group:
                self._scheduled[i] = True
            self._in_group = []
        return self._state(), reward, self.done, self.action_mask(), {}

    @property
    def done(self) -> bool:
        return all(self._scheduled) and not self._in_group

    # ------------------------------------------------------------- internals
    def _valid(self, action: int) -> bool:
        W = self.cfg.window
        if action < W:
            return (action < len(self._queue)
                    and not self._scheduled[action]
                    and action not in self._in_group
                    and len(self._in_group) < self.cfg.c_max)
        p = self.partitions[action - W]
        return len(self._in_group) >= 1 and p.arity == len(self._in_group)

    def action_mask(self) -> np.ndarray:
        return np.array([self._valid(a) for a in range(self.n_actions)], dtype=bool)

    def _state(self) -> np.ndarray:
        W = self.cfg.window
        out = np.zeros((W, self.n_features + N_FLAGS), np.float32)
        progress = len(self._in_group) / max(1, self.cfg.c_max)
        for i in range(W):
            if i >= len(self._queue):
                out[i, self.n_features + 3] = 1.0       # padding
                continue
            out[i, : self.n_features] = self._queue[i].features()
            out[i, self.n_features + 0] = float(not self._scheduled[i] and i not in self._in_group)
            out[i, self.n_features + 1] = float(i in self._in_group)
            out[i, self.n_features + 2] = float(self._scheduled[i])
            out[i, self.n_features + 4] = progress
        flat = out.reshape(-1)
        if not self.cfg.obs_context:
            return flat
        if self._ctx is None:
            return np.concatenate([flat, np.zeros((self.context_dim,),
                                                  np.float32)])
        # busy, ages, depth — in that order (docs/observation.md)
        oc = dispatch_obs_context(self._ctx, W)
        return np.concatenate([flat, np.asarray(oc.busy_units),
                               np.asarray(oc.ages),
                               np.asarray(oc.queue_depth)[None]])

    # ------------------------------------------------------------- rewards
    def _close_reward(self, group: list[JobProfile], partition: Partition) -> float:
        means = self._window_means()
        ri = sum(
            self._r_i(job, beta, s.units, means)
            for job, (_, s, beta) in zip(group, partition.slots)
        )
        ct = corun_time(group, partition)
        st = solo_run_time(group)
        rf = (st / ct - 1.0) * self.cfg.r_f_scale if ct > 0 else 0.0
        reward = self.cfg.r_i_weight * ri + rf
        if (self.cfg.obs_context and self.cfg.ctx_fit_weight > 0
                and self._ctx is not None
                and find_offsets(partition, list(self._ctx.free_units)) is None):
            # the partition cannot first-fit the observed free units
            reward -= self.cfg.ctx_fit_weight
        return reward

    def _window_means(self) -> dict:
        jobs = self._queue
        return {
            "compute": float(np.mean([j.compute_pct for j in jobs])) or 1e-9,
            "memory": float(np.mean([j.memory_pct for j in jobs])) or 1e-9,
            "duration": float(np.mean([j.solo_time() for j in jobs])) or 1e-9,
        }

    def _r_i(self, job: JobProfile, beta: float, units: int, means: dict) -> float:
        """Paper Table VI intermediate reward, TPU-mapped:
        SmAllocRatio = chips fraction x β; MemoryAllocRatio = slice bandwidth
        fraction (co-residents all access the slice's bandwidth, like the
        GI's αm)."""
        sm_alloc = (units / N_UNITS) * beta
        mem_alloc = units / N_UNITS
        compute_ratio = job.compute_pct / max(means["compute"], 1e-9)
        memory_ratio = job.memory_pct / max(means["memory"], 1e-9)
        duration_ratio = job.solo_time() / max(means["duration"], 1e-9)
        return (sm_alloc * compute_ratio + mem_alloc * memory_ratio) * duration_ratio ** 2
