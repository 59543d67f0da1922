"""RL environment for co-scheduling + hierarchical partitioning (paper §IV-C).

Port of the scalar half of ``repro/core/env.py``: the configuration, the
arrival-aware context helpers and the stateful reference environment
:class:`CoScheduleEnv` that ``RLScheduler`` steps.  The environment is numpy
and float64 Python on the host; only the agent's forward pass runs on the
device.  The vectorized functional environment of the reference waits for
the training slice.

State: W slots x (f profile features + 5 status flags), flattened — the
paper's input layer ``W x (f+5)`` — plus, with ``EnvConfig.obs_context``,
the busy-unit mask, per-slot queueing ages and pending depth
(``docs/observation.md``).  Actions: W *select-job-i into the current group*
+ N_p *close the group with partition p*.  Rewards (paper Table VI):
    on close:  Σ_j r_i(j)  +  r_f = (SoloRunTime/CoRunTime - 1) x 100
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np

from repro_torch.core.partition import N_UNITS, Partition, enumerate_partitions, find_offsets
from repro_torch.core.perfmodel import corun_time, solo_run_time
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
    """Normalized context block appended to the observation (f32 arrays).

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
