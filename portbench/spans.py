"""The program's own profiler ranges in a traced co-run.

The port marks its layers with ``torch.profiler.record_function`` ranges:
``executor.macro_step`` and ``executor.barrier`` (the executor),
``step.prefill`` and ``step.decode`` (the serve steps), ``kv_cache.init``
(a cache's allocation and zero fill) and ``moe.host_sync`` (the MoE
decode's read of its expert counts).  This module reads them from the
Kineto events of ``trace.Trace.events``:

- the span instances: every ``user_annotation`` on the host thread that
  opened ``executor.macro_step``, the harness's ``portbench:*`` spans left
  out;
- the device work a span instance launched: the kernels and memsets whose
  runtime launch call (matched by ``correlation``) falls on that thread
  inside the instance;
- the device's idle time by owner: the traced wall less the union of all
  kernel intervals (as ``metrics/device_idle_share.py`` counts it), each
  idle interval split over time by the innermost program span open on
  that thread: ``moe.host_sync`` is a host sync, an ``executor.*`` span
  the executor, any other span dispatch (a step's own host work and
  launches), and no program span the harness outside the program.

The wall is placed on the trace's clock to end where the device and the
last macro-step end, whichever is later.  Without the program's spans (a
program that has none) there is nothing to read: :func:`of` gives None.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

from portbench.trace import busy_us

MACRO = "executor.macro_step"
HOST_SYNC = "moe.host_sync"
OWNERS = ("executor", "dispatch", "host_sync", "outside")


def owner(name: str | None) -> str:
    """The owner of idle time under innermost program span ``name``."""
    if name is None:
        return "outside"
    if name == HOST_SYNC:
        return "host_sync"
    return "executor" if name.startswith("executor.") else "dispatch"


class Spans:
    """The program's span instances on the executor's thread, the device
    work each launched, and the device's idle time by owner."""

    def __init__(self, events: list, wall_s: float):
        macro = next(e for e in events
                     if e.get("cat") == "user_annotation" and e["name"] == MACRO)
        thread = (macro.get("pid"), macro.get("tid"))

        def mine(e):
            return (e.get("pid"), e.get("tid")) == thread

        self.spans = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                             if e.get("cat") == "user_annotation" and mine(e)
                             and not e["name"].startswith("portbench:")),
                            key=lambda s: (s[0], -s[1]))
        launched = {e["args"]["correlation"]: e["ts"] for e in events
                    if e.get("cat") in ("cuda_runtime", "cuda_driver") and mine(e)
                    and "correlation" in e.get("args", {})}
        # (launch time, start, end, is a kernel) of the work this thread launched
        self.work = sorted((launched[e["args"]["correlation"]], e["ts"], e["ts"] + e["dur"],
                            e.get("cat") == "kernel") for e in events
                           if e.get("cat") in ("kernel", "gpu_memset")
                           and e.get("args", {}).get("correlation") in launched)
        self._launch_ts = [w[0] for w in self.work]
        kernels = [(e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") == "kernel"]
        self.wall_us = wall_s * 1e6
        self.busy_us = busy_us(kernels)
        end = max([s[1] for s in self.spans if s[2] == MACRO] + [b for _, b in kernels])
        self.idle_us = self._idle_by_owner(_gaps(kernels, end - self.wall_us, end))

    def named(self, name: str) -> list:
        return [s for s in self.spans if s[2] == name]

    def inside(self, name: str, outer: tuple) -> list:
        """The instances of ``name`` within span instance ``outer``."""
        return [s for s in self.named(name) if outer[0] <= s[0] and s[1] <= outer[1]]

    def launched(self, span: tuple, kernels_only: bool = False) -> list:
        """``(start, end)`` of the device work launched inside ``span``."""
        lo = bisect.bisect_left(self._launch_ts, span[0])
        hi = bisect.bisect_right(self._launch_ts, span[1])
        return [(a, b) for _, a, b, k in self.work[lo:hi] if k or not kernels_only]

    def latency_ms(self, name: str):
        """The mean, over the instances of ``name`` that launched a kernel,
        of the first such kernel's start to the last one's end."""
        out = []
        for s in self.named(name):
            iv = self.launched(s, kernels_only=True)
            if iv:
                out.append(max(b for _, b in iv) - min(a for a, _ in iv))
        return sum(out) / len(out) / 1e3 if out else None

    def idle_share(self, who: str) -> float:
        return self.idle_us[who] / self.wall_us

    def _idle_by_owner(self, gaps: list) -> dict:
        out = defaultdict(float)
        segs = _segments(self.spans)
        i = 0
        for a, b in gaps:
            owned = 0.0
            while i < len(segs) and segs[i][1] <= a:
                i += 1
            j = i
            while j < len(segs) and segs[j][0] < b:
                s, e, who = segs[j]
                d = min(b, e) - max(a, s)
                out[who] += d
                owned += d
                j += 1
            out["outside"] += (b - a) - owned
        return {k: out[k] for k in OWNERS}


def _gaps(kernels: list, start: float, end: float) -> list:
    """The intervals of ``[start, end]`` that no kernel covers."""
    out, t = [], start
    for a, b in sorted(kernels):
        if a > t:
            out.append((t, min(a, end)))
        t = max(t, b)
        if t >= end:
            break
    if t < end:
        out.append((t, end))
    return [(a, b) for a, b in out if b > a]


def _segments(spans: list) -> list:
    """``(start, end, owner)`` of each stretch of time with a program span
    open, by the innermost one (the spans of one thread nest)."""
    points = sorted([(s, 1, n) for s, _, n in spans] + [(e, 0, n) for _, e, n in spans],
                    key=lambda p: (p[0], p[1]))
    out, stack, t = [], [], None
    for at, opens, name in points:
        if stack and at > t:
            out.append((t, at, owner(stack[-1])))
        if opens:
            stack.append(name)
        else:
            del stack[len(stack) - 1 - stack[::-1].index(name)]
        t = at
    return out


def of(ctx):
    """The run's :class:`Spans` (read once and kept in ``ctx``), or None
    without a traced co-run that holds the program's spans."""
    if "spans" not in ctx:
        tr = ctx.get("trace")
        found = tr is not None and tr.kernels and any(
            e.get("cat") == "user_annotation" and e["name"] == MACRO for e in tr.events)
        ctx["spans"] = Spans(tr.events, tr.wall_s) if found else None
    return ctx["spans"]
