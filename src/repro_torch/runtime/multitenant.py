"""Level-2 (logical, ≈MPS) co-residency executor on one GPU.

Port of ``repro/runtime/multitenant.py``.  Co-resident tenants each own a
``torch.cuda.Stream``; one macro-step enqueues every live tenant's quanta
on its own stream and then synchronises all of them (the reference's
``jax.block_until_ready``).  Concurrent streams are how the H100 overlaps
one tenant's tensor-core work with another's memory streams, which the TPU
analogue gets from XLA's scheduling of one fused program.  Fractional
compute shares β map to per-tenant quantum counts,
``max(1, round(β_i / Σβ * quanta_per_cycle * n))``, as in the reference.

On the CPU (``stream=None``) the same bookkeeping runs sequentially.

A tenant's state must be made on its own stream (or ``record_stream``ed
onto it) so the caching allocator never hands a live buffer to another
stream; each run also makes every tenant stream wait for the work queued
on the current stream before it, which covers set-up done there.  Finish
times are read with ``perf_counter`` after the synchronise.  For the
profiler, each macro-step of :class:`FusedCoRunner` is a range
``executor.macro_step`` and its synchronise a range ``executor.barrier``
inside it.

One difference from the reference: a tenant that has finished is not
stepped again.  The reference's fused program keeps advancing every
tenant until the last one finishes, past its ``total_steps``.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Any, Callable

import torch


@dataclass
class Tenant:
    name: str
    step_fn: Callable                 # state -> state
    state: Any
    share: float = 1.0                # Level-2 β
    steps_done: int = 0
    time_spent: float = 0.0
    stream: torch.cuda.Stream | None = None   # None: run on the CPU


def _on(stream):
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


def _start(tenants: list[Tenant]) -> None:
    for t in tenants:
        if t.stream is not None:
            t.stream.wait_stream(torch.cuda.current_stream(t.stream.device))


def _finish(tenants: list[Tenant]) -> None:
    for t in tenants:
        if t.stream is not None:
            t.stream.synchronize()


def fuse_tenants(tenants: list[Tenant], quanta_per_cycle: int = 4):
    """One macro-step advancing each live tenant by its quanta on its own
    stream.  Returns ``(macro, quanta)``; ``macro(states, live)`` returns
    the new states, leaving a tenant whose ``live`` entry is False as it is."""
    total = sum(t.share for t in tenants)
    quanta = [max(1, round(t.share / total * quanta_per_cycle * len(tenants)))
              for t in tenants]

    def macro(states, live):
        out = []
        for i, (t, st, q) in enumerate(zip(tenants, states, quanta)):
            if live[i]:
                with _on(t.stream):
                    for _ in range(q):
                        st = t.step_fn(st)
            out.append(st)
        return tuple(out)

    return macro, quanta


class FusedCoRunner:
    """Run a co-scheduled group to completion, tenants concurrent on their
    streams."""

    def __init__(self, tenants: list[Tenant], total_steps: dict[str, int],
                 quanta_per_cycle: int = 4):
        self.tenants = tenants
        self.total_steps = total_steps
        self.macro, self.quanta = fuse_tenants(tenants, quanta_per_cycle)

    def run(self) -> dict[str, float]:
        """Returns per-tenant finish times (wall clock, seconds)."""
        states = tuple(t.state for t in self.tenants)
        finish: dict[str, float] = {}
        _start(self.tenants)
        t0 = time.perf_counter()
        active = list(range(len(self.tenants)))
        while active:
            with torch.profiler.record_function("executor.macro_step"):
                states = self.macro(states, [i in active for i in range(len(self.tenants))])
                with torch.profiler.record_function("executor.barrier"):
                    _finish(self.tenants)
                now = time.perf_counter() - t0
                for i in list(active):
                    t = self.tenants[i]
                    t.steps_done += self.quanta[i]
                    if t.steps_done >= self.total_steps[t.name]:
                        finish[t.name] = now
                        active.remove(i)
        for t, st in zip(self.tenants, states):
            t.state = st
        return finish


class QuantumExecutor:
    """Round-robin quantum scheduler with straggler-aware work rebalancing."""

    def __init__(self, tenants: list[Tenant], total_steps: dict[str, int],
                 straggler_factor: float = 2.0):
        self.tenants = tenants
        self.total_steps = total_steps
        self.straggler_factor = straggler_factor
        self.events: list[str] = []

    def _quanta(self) -> dict[str, int]:
        total = sum(t.share for t in self.tenants)
        return {t.name: max(1, round(4 * t.share / total * len(self.tenants)))
                for t in self.tenants}

    def run(self) -> dict[str, float]:
        finish: dict[str, float] = {}
        _start(self.tenants)
        t0 = time.perf_counter()
        quanta = self._quanta()
        active = {t.name: t for t in self.tenants}
        expected: dict[str, float] = {}
        while active:
            for name, t in list(active.items()):
                q = quanta[name]
                qt0 = time.perf_counter()
                with _on(t.stream):
                    for _ in range(q):
                        t.state = t.step_fn(t.state)
                _finish([t])
                dt = time.perf_counter() - qt0
                t.steps_done += q
                t.time_spent += dt
                per_step = dt / q
                # straggler mitigation: a tenant running far beyond its own
                # historical per-step time gets one quantum stolen this cycle
                hist = expected.setdefault(name, per_step)
                if per_step > self.straggler_factor * hist and quanta[name] > 1:
                    quanta[name] -= 1
                    self.events.append(f"straggler:{name} quanta->{quanta[name]}")
                expected[name] = 0.8 * hist + 0.2 * per_step
                if t.steps_done >= self.total_steps[name]:
                    finish[name] = time.perf_counter() - t0
                    del active[name]
        return finish
