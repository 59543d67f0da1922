"""Dispatch policies for the online cluster simulator.
Port of ``repro/online/policies.py``: the RL policy runs the port's
``RLScheduler``, whose agent's forward runs on the agent's device.

Every policy speaks the paper's §IV-B online protocol: submissions arrive
as ``(binary, fresh_profile)`` pairs; a binary the repository has never
seen runs **solo** on the full pod (being profiled as it runs) and its
profile enters the repository, while previously-profiled jobs are
co-scheduled by the policy's planner.  All policies therefore pay the same
first-sight profiling cost — comparisons across policies on one trace are
apples to apples.

Every dispatch additionally receives the simulator's
:class:`~repro_torch.core.env.DispatchContext` — the free-unit occupancy mask,
per-submission queueing ages, and pending-queue depth at the dispatch
instant.  The base protocol accepts it uniformly so the simulator can pass
it unconditionally; only the RL policy consumes it (an ``obs_context``
agent folds it into its observation — the arrival-aware state of
``docs/observation.md``), while the heuristic baselines plan from profiles
alone, exactly as before.

    RLDispatchPolicy      — the trained agent via
                            ``RLScheduler.schedule_submissions`` (constraint
                            guard included); ``hot_swap`` lets the periodic
                            re-training loop replace the agent mid-trace.
    TimeSharingPolicy     — everything solo on the full pod (the 1.0
                            baseline the paper normalizes against).
    GreedyPackerPolicy    — first-fit complementary packing: anchor the
                            longest-waiting job, greedily add the partner
                            whose best partition minimizes the co-run/solo
                            ratio, stop when adding stops helping.
    StaticPartitionPolicy — the exhaustive static baselines of
                            :mod:`repro_torch.core.baselines` (``mig_only``,
                            ``mps_only``, ``mig_mps_default``, ``oracle``)
                            applied per dispatch window.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass

from repro_torch.core.baselines import POLICIES, _best_for_group, time_sharing
from repro_torch.core.env import EnvConfig
from repro_torch.core.partition import enumerate_partitions, solo_partition
from repro_torch.core.perfmodel import solo_run_time
from repro_torch.core.problem import Schedule
from repro_torch.core.profiles import JobProfile, ProfileRepository
from repro_torch.core.scheduler import (
    DispatchDecision, Placement, RLScheduler, submission_protocol,
    to_placements,
)


@dataclass
class PolicyStats:
    unprofiled_jobs: int = 0
    planned_jobs: int = 0


class DispatchPolicy:
    """Repository protocol + a planner hook (:meth:`plan`) for subclasses.

    :meth:`decide` is the **single dispatch entry point**: it runs the
    shared :func:`~repro_torch.core.scheduler.submission_protocol` (first sight:
    solo + insert; afterwards: plan) with this policy's planner — so every
    policy pays the identical first-sight profiling cost the RL scheduler
    does — and returns one
    :class:`~repro_torch.core.scheduler.DispatchDecision` carrying the planned
    schedule, the width-fitted placements the slice-level simulator
    consumes, and this window's first-sight/planned counts.  The
    historical ``dispatch()`` / ``placements()`` methods survive as thin
    deprecation shims over the same protocol; subclasses that still
    override them (the pre-decide extension points) are honored —
    :meth:`decide` detects the override and routes through it.

    ``plan_window`` caps how many profiled jobs reach one :meth:`plan` call
    (chunked like the RL window); ``None`` plans the whole batch at once.
    """

    name = "base"

    def __init__(self, repository: ProfileRepository | None = None,
                 plan_window: int | None = None):
        # `is not None`: an empty repository is falsy (len 0) but still the
        # caller's shared store — never replace it
        self.repository = repository if repository is not None else ProfileRepository()
        self.plan_window = plan_window
        self.stats = PolicyStats()
        self._last_schedule: Schedule | None = None

    # ------------------------------------------------ the one entry point

    def decide(self, submissions: list[tuple[str, JobProfile | None]],
               context=None) -> DispatchDecision:
        """Plan one dispatch window.  ``context`` (a
        :class:`~repro_torch.core.env.DispatchContext`) is accepted by every
        policy so the simulator can pass its snapshot unconditionally;
        the base planner contract ``plan(queue)`` is context-blind, so it
        is *not* forwarded — the RL delegate consumes it."""
        before = (self.stats.unprofiled_jobs, self.stats.planned_jobs)
        cls = type(self)
        if cls.dispatch is not DispatchPolicy.dispatch:
            # legacy subclass extension point: honor the override (its
            # super() chain lands back in the shim below)
            sched = self.dispatch(submissions, context=context)
            pls = to_placements(sched)
        elif cls.placements is not DispatchPolicy.placements:
            self._last_schedule = None
            pls = self.placements(submissions, context=context)
            sched = self._last_schedule
        else:
            sched = self._plan_schedule(submissions, context=context)
            pls = to_placements(sched)
        return DispatchDecision(
            schedule=sched, placements=tuple(pls),
            first_sight=self.stats.unprofiled_jobs - before[0],
            planned=self.stats.planned_jobs - before[1])

    def _plan_schedule(self, submissions, context=None) -> Schedule:
        """The shared protocol body (the RL policy swaps in its delegate)."""
        def on_unprofiled(path, fresh):
            self.stats.unprofiled_jobs += 1

        def on_window(chunk):
            self.stats.planned_jobs += len(chunk)

        return submission_protocol(self.repository, submissions, self.plan,
                                   window=self.plan_window,
                                   on_unprofiled=on_unprofiled,
                                   on_window=on_window)

    # ------------------------------------------------- deprecation shims

    def dispatch(self, submissions: list[tuple[str, JobProfile | None]],
                 context=None) -> Schedule:
        """Deprecated: ``decide(...).schedule`` replaces this."""
        warnings.warn(
            "DispatchPolicy.dispatch() is deprecated; use "
            "decide(submissions, context).schedule",
            DeprecationWarning, stacklevel=2)
        sched = self._plan_schedule(submissions, context=context)
        self._last_schedule = sched
        return sched

    def placements(self, submissions: list[tuple[str, JobProfile | None]],
                   context=None) -> list[Placement]:
        """Deprecated: ``decide(...).placements`` replaces this."""
        warnings.warn(
            "DispatchPolicy.placements() is deprecated; use "
            "decide(submissions, context).placements",
            DeprecationWarning, stacklevel=2)
        return to_placements(self.dispatch(submissions, context=context))

    def plan(self, queue: list[JobProfile]) -> Schedule:
        raise NotImplementedError


class TimeSharingPolicy(DispatchPolicy):
    name = "time_sharing"

    def plan(self, queue):
        return time_sharing(queue)


class GreedyPackerPolicy(DispatchPolicy):
    """Greedy complementary packing under the constraint-1 guard.

    Groups only form while the best partition's co-run time stays *below*
    the group's summed solo time, so — like the RL scheduler's fallback —
    no dispatch is ever worse than time sharing.  ``max_perms`` caps the
    slot-ordering sweep (this is an explicitly approximate policy).
    """

    name = "greedy_packer"

    def __init__(self, repository=None, c_max: int = 4, max_group: int = 2,
                 max_perms: int | None = 4):
        super().__init__(repository)
        self.max_group = min(max_group, c_max)
        self.max_perms = max_perms
        self.partitions = enumerate_partitions(c_max)

    def plan(self, queue):
        remaining = list(queue)
        sched = Schedule()
        solo = solo_partition()
        while remaining:
            group = [remaining.pop(0)]
            chosen = None                     # (partition, perm) of the group
            while len(group) < self.max_group and remaining:
                best = None
                for cand in remaining:
                    trial = group + [cand]
                    t, p, perm = _best_for_group(trial, self.partitions,
                                                 self.max_perms)
                    if p is None:
                        continue
                    ratio = t / solo_run_time(trial)
                    if ratio < 1.0 and (best is None or ratio < best[0]):
                        best = (ratio, cand, p, perm)
                if best is None:
                    break
                group.append(best[1])
                remaining.remove(best[1])
                chosen = (best[2], best[3])
            if chosen is None:
                sched.add(group, solo)
            else:
                p, perm = chosen
                sched.add([group[i] for i in perm], p)
        return sched


class StaticPartitionPolicy(DispatchPolicy):
    """Per-window exhaustive baseline (``mig_only`` / ``mps_only`` /
    ``mig_mps_default`` / ``oracle``) from :mod:`repro_torch.core.baselines`."""

    def __init__(self, baseline: str = "mig_mps_default", repository=None,
                 c_max: int = 4):
        super().__init__(repository)
        assert baseline in POLICIES, baseline
        self.name = baseline
        self._fn = POLICIES[baseline]
        self.c_max = c_max

    def plan(self, queue):
        return self._fn(queue, self.c_max)


class RLDispatchPolicy(DispatchPolicy):
    """The trained agent, online: delegates the whole protocol (including
    first-sight solo runs and the constraint guard) to
    :meth:`RLScheduler.schedule_submissions`; ``hot_swap`` installs freshly
    re-trained agents between dispatches.  The only context-aware policy:
    the dispatch snapshot flows into the agent's observation when its env
    runs with ``obs_context`` (and is harmlessly ignored otherwise)."""

    name = "rl"

    def __init__(self, agent, env_cfg: EnvConfig | None = None,
                 repository: ProfileRepository | None = None):
        super().__init__(repository)
        self.scheduler = RLScheduler(agent, env_cfg, self.repository)

    def _plan_schedule(self, submissions, context=None):
        # keep PolicyStats live even though the protocol is delegated:
        # cross-policy analyses read .stats uniformly.  Derived from the
        # scheduler's own counter delta so there is exactly one protocol
        # implementation to stay in sync with.
        before = self.scheduler.stats.unprofiled_jobs
        sched = self.scheduler.schedule_submissions(submissions,
                                                    context=context)
        fresh = self.scheduler.stats.unprofiled_jobs - before
        self.stats.unprofiled_jobs += fresh
        self.stats.planned_jobs += len(submissions) - fresh
        return sched

    def plan(self, queue):
        return self.scheduler.schedule(queue)

    def hot_swap(self, agent) -> None:
        self.scheduler.agent = agent

    @property
    def agent(self):
        return self.scheduler.agent
