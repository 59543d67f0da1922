"""Online phase (paper §IV-B): trained agent -> (L_JS, L_R) for a queue.

Port of ``repro/core/scheduler.py``; the agent is duck-typed (any object
with ``act(state, mask, greedy=True)``), so the same scheduler runs a
:class:`~repro_torch.core.agent.DQNAgent` on the card or on the CPU.

The agent runs greedily (ε = 0) on the stateful reference env — greedy
calls do not advance the agent's ε-decay schedule, so scheduling/evaluation
frequency never perturbs training exploration. The §IV-A constraint
``CoRunTime <= SoloRunTime`` is then *enforced by construction*: any group
whose predicted co-run loses to time sharing is split back into solo runs
(the paper's constraint-1 guard).  Jobs without a profile in the repository
are excluded from co-scheduling and executed solo while being profiled
(paper's online protocol).

Two shared pieces sit between any planner and the cluster simulator:

* :func:`submission_protocol` — the single first-sight implementation
  (unprofiled binary -> solo run + repository insert) every dispatcher
  wraps, so the profiling cost is identical across policies by
  construction.  It also carries the dispatch-time
  :class:`~repro_torch.core.env.DispatchContext` (free-unit mask, per-submission
  ages, pending depth) down to context-aware planners, re-chunked so each
  planning window sees exactly its own submissions' ages.
* :func:`to_placements` — width-fits a planned :class:`Schedule` into
  :class:`Placement`\\ s: dedicated (single-share) slices shrink to their
  job's ``requested_units`` hint so right-sized jobs occupy only the slice
  range they can use, which is what lets the simulator run independent
  groups concurrently on disjoint slices and backfill small jobs into idle
  gaps.  MPS-shared slices keep their planned width (the share semantics
  assume the planned slice), and a job without a hint keeps the full
  width — offline schedules are bit-identical through this function.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.env import CoScheduleEnv, DispatchContext, EnvConfig
from repro_torch.core.partition import Partition, Slice, slice_label, solo_partition
from repro_torch.core.perfmodel import corun_time, solo_run_time
from repro_torch.core.problem import Schedule
from repro_torch.core.profiles import JobProfile, ProfileRepository


@dataclass
class SchedulerStats:
    fallback_groups: int = 0
    unprofiled_jobs: int = 0
    windows: int = 0                 # RL scheduling windows run by submissions


def submission_protocol(repository: ProfileRepository,
                        submissions: list[tuple[str, JobProfile | None]],
                        plan, window: int | None = None,
                        on_unprofiled=None, on_window=None,
                        context: DispatchContext | None = None) -> Schedule:
    """The §IV-B online submission protocol, shared by every dispatcher.

    Submissions are ``(binary_path, maybe-fresh-profile)`` pairs.  A binary
    the repository has never seen runs **solo** on the full pod (profiled as
    it runs) and its fresh measurement enters the repository — a first
    sight with no measurement is reported via ``on_unprofiled`` but cannot
    be scheduled.  The profiled remainder is chunked into ``window``-sized
    batches (``None``: one batch) and handed to ``plan(queue) -> Schedule``.
    ``RLScheduler.schedule_submissions`` and the online package's
    ``DispatchPolicy.dispatch`` are both thin wrappers over this function,
    so the first-sight cost is identical across policies by construction.

    ``context`` is the dispatcher's cluster-state snapshot: its ``ages_s``
    align positionally with ``submissions``.  When given, each chunk's
    planner is called as ``plan(queue, context)`` with the ages filtered to
    that chunk's profiled jobs and ``queue_depth`` grown by the profiled
    submissions still waiting in later chunks of this same window (they
    queue behind this plan exactly like pending arrivals do).  ``None``
    preserves the historical ``plan(queue)`` call unchanged.
    """
    solo = solo_partition()
    sched = Schedule()
    profiled: list[JobProfile] = []
    ages: list[float] = []
    for k, (path, fresh) in enumerate(submissions):
        prof = repository.lookup(path)
        if prof is None:
            if on_unprofiled is not None:
                on_unprofiled(path, fresh)
            if fresh is not None:       # measured during this solo run
                repository.insert(path, fresh)
                sched.add([fresh], solo)
            continue
        profiled.append(prof)
        if context is not None:
            ages.append(context.ages_s[k] if k < len(context.ages_s) else 0.0)
    W = window or max(1, len(profiled))
    for lo in range(0, len(profiled), W):
        chunk = profiled[lo:lo + W]
        if on_window is not None:
            on_window(chunk)
        if context is None:
            inner = plan(chunk)
        else:
            later = len(profiled) - (lo + len(chunk))
            inner = plan(chunk, DispatchContext(
                free_units=context.free_units,
                ages_s=tuple(ages[lo:lo + len(chunk)]),
                queue_depth=context.queue_depth + later,
                now_s=context.now_s))
        for g, p in zip(inner.groups, inner.partitions):
            sched.add(g, p)
    return sched


@dataclass
class Placement:
    """One co-run group bound to the (possibly sub-pod) partition it will
    occupy.  The *which slice units* decision is the simulator's (its
    occupancy map first-fits the partition's slices onto free ranges);
    the placement fixes *how wide* each slice is."""

    group: list[JobProfile]
    partition: Partition


@dataclass(frozen=True)
class DispatchDecision:
    """The single result of one dispatch window — what
    ``DispatchPolicy.decide`` returns.

    Collapses the historical ``dispatch()`` (schedule), ``placements()``
    (width-fitted placements) and per-call stats bookkeeping into one
    value: ``schedule`` is the planned :class:`Schedule` (``None`` only
    when a legacy ``placements``-override subclass produced the
    placements without one), ``placements`` is what the slice-level
    simulator consumes, and ``first_sight`` / ``planned`` count this
    window's submissions on each side of the profiling protocol."""

    schedule: Schedule | None
    placements: tuple[Placement, ...]
    first_sight: int = 0
    planned: int = 0


def to_placements(sched: Schedule) -> list[Placement]:
    """Width-fit a planned Schedule into slice-level placements.

    Dedicated (single-share) slices shrink to their job's
    ``requested_units`` placement hint — never grow, and MPS-shared slices
    are untouched.  Groups and slot order are preserved, so per-job finish
    times still come from :func:`~repro_torch.core.perfmodel.corun` on the fitted
    partition.  Schedules over jobs without width hints pass through
    unchanged (identical objects), which keeps full-pod dispatch
    bit-compatible."""
    out: list[Placement] = []
    for g, p in zip(sched.groups, sched.partitions):
        new_slices = list(p.slices)
        changed = False
        for pos, (si, s, _beta) in enumerate(p.slots):
            if len(s.shares) != 1:
                continue
            req = g[pos].requested_units
            if req < s.units:
                new_slices[si] = Slice(req, s.shares)
                changed = True
        part = (Partition(tuple(new_slices), slice_label(tuple(new_slices)))
                if changed else p)
        out.append(Placement(list(g), part))
    return out


class RLScheduler:
    def __init__(self, agent, env_cfg: EnvConfig | None = None,
                 repository: ProfileRepository | None = None):
        self.agent = agent
        self.env_cfg = env_cfg or EnvConfig()
        # `or` would discard an *empty* repository (len 0 is falsy) and
        # silently sever the caller's handle to the shared profile store
        self.repository = repository if repository is not None else ProfileRepository()
        self.stats = SchedulerStats()

    def schedule(self, queue: list[JobProfile],
                 context: DispatchContext | None = None) -> Schedule:
        """Greedy episode over ``queue``; ``context`` is the dispatch-time
        cluster snapshot an ``obs_context`` environment folds into the
        observation (ignored — zero block — otherwise)."""
        env = CoScheduleEnv(self.env_cfg)
        state, mask = env.reset(queue, context)
        guard = 0
        while not env.done:
            action = self.agent.act(state, mask, greedy=True)
            state, _, _, mask, _ = env.step(action)
            guard += 1
            assert guard < 10 * self.env_cfg.window, "scheduler failed to terminate"
        return self._enforce_constraints(env.schedule)

    def schedule_submissions(self, submissions: list[tuple[str, JobProfile | None]],
                             context: DispatchContext | None = None) -> Schedule:
        """:func:`submission_protocol` with the agent as planner.

        Unprofiled jobs run solo (full pod) and enter the repository; the
        profiled remainder is co-scheduled by the agent.  More profiled jobs
        than the agent's window are chunked into successive window-sized RL
        episodes (each counted in ``stats.windows``) — the event-driven
        cluster simulator hands over whatever is pending, which can exceed W.
        ``context`` (the simulator's dispatch snapshot) reaches each episode
        re-chunked by :func:`submission_protocol`.
        """
        def on_unprofiled(path, fresh):
            self.stats.unprofiled_jobs += 1

        def on_window(chunk):
            self.stats.windows += 1

        return submission_protocol(self.repository, submissions,
                                   self.schedule, window=self.env_cfg.window,
                                   on_unprofiled=on_unprofiled,
                                   on_window=on_window, context=context)

    def _enforce_constraints(self, sched: Schedule) -> Schedule:
        solo = solo_partition()
        out = Schedule()
        for g, p in zip(sched.groups, sched.partitions):
            if len(g) > 1 and corun_time(g, p) > solo_run_time(g):
                self.stats.fallback_groups += 1
                for j in g:
                    out.add([j], solo)
            else:
                out.add(g, p)
        return out
