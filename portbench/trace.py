"""Reading a ``torch.profiler`` trace: device kernels, the union of their
intervals, the host spans open at each launch, and the breakdown the
result line carries.

The union-of-intervals arithmetic and the attribution of a kernel to the
marked regions around the host call that launched it are copied from the
port's ``tools/torch_profile.py`` (``busy_us``, ``region_hits``).
"""
from __future__ import annotations

import bisect
import json
import os
from collections import Counter, defaultdict


def busy_us(intervals) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


class Trace:
    """The kernels of one profiled window, each with the names of the host
    spans (``record_function`` regions, the package's and the harness's)
    open on its launching thread when it was launched."""

    def __init__(self, events: list, wall_s: float):
        self.wall_s = wall_s
        self.kernels = [e for e in events if e.get("cat") == "kernel"]
        self.labels = _open_spans(events, self.kernels)
        self.events = events

    @classmethod
    def from_profiler(cls, prof, path: str, wall_s: float) -> "Trace":
        prof.export_chrome_trace(path)
        try:
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return cls(events, wall_s)

    def intervals(self, pick=lambda k, labels: True):
        return [(k["ts"], k["ts"] + k["dur"]) for k, lab in zip(self.kernels, self.labels)
                if pick(k, lab)]

    def busy_s(self, pick=lambda k, labels: True) -> float:
        return busy_us(self.intervals(pick)) / 1e6

    def breakdown(self) -> dict:
        """The 10 kernel names with the most device time (the union of each
        name's intervals), and the device's idle time between kernels
        summed by the host call that was running when each gap began: the
        10 largest."""
        by_name = defaultdict(list)
        for k in self.kernels:
            by_name[k["name"]].append((k["ts"], k["ts"] + k["dur"]))
        ops = sorted(((n, busy_us(iv) / 1e6) for n, iv in by_name.items()),
                     key=lambda p: -p[1])[:10]
        spans = sorted((k["ts"], k["ts"] + k["dur"]) for k in self.kernels)
        gaps, end = [], None
        for a, b in spans:
            if end is not None and a > end:
                gaps.append((end, a))
            end = b if end is None else max(end, b)
        host = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in self.events
                      if e.get("cat") in ("cpu_op", "cuda_runtime", "cuda_driver"))
        starts = [h[0] for h in host]
        idle = Counter()
        for a, b in gaps:
            # the latest-starting host call still running when the gap began
            i = bisect.bisect_right(starts, a) - 1
            while i >= 0 and host[i][1] <= a and a - host[i][0] < 1e6:
                i -= 1
            idle[host[i][2] if i >= 0 and host[i][1] > a else "no host call"] += (b - a) / 1e6
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in idle.most_common(10)]}


def _open_spans(events: list, kernels: list) -> list:
    """For each kernel, the frozenset of ``user_annotation`` span names open
    on the thread of the runtime call that launched it, at that call (one
    sweep over the spans' ends and the launch times of each thread)."""
    launches = {e["args"]["correlation"]: (e["tid"], e["ts"]) for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    points = defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation":
            points[e["tid"]].extend(((e["ts"], 0, e["name"]), (e["ts"] + e["dur"], 2, e["name"])))
    out = [frozenset()] * len(kernels)
    for i, k in enumerate(kernels):
        tid, ts = launches.get(k.get("args", {}).get("correlation"), (None, None))
        if tid in points:
            points[tid].append((ts, 1, i))
    for pts in points.values():
        open_spans = Counter()
        for _, kind, what in sorted(pts, key=lambda p: (p[0], p[1])):
            if kind == 1:
                out[what] = frozenset(n for n, c in open_spans.items() if c > 0)
            else:
                open_spans[what] += 1 if kind == 0 else -1
    return out
