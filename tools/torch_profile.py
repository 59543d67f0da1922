#!/usr/bin/env python3
"""Where the device time of the co-scheduled llama3-8b pair goes.

    python3 tools/torch_profile.py [--out DIR]

Builds the pair of ``chip_smoke.py`` (prefill 1 x 8192 tokens, decode batch
4 against a 32768-slot cache, full width, bf16) on one CUDA card, then runs
under ``torch.profiler``: one prefill step alone, one decode step alone,
and one co-run macro-step of ``FusedCoRunner`` (both tenants on their
streams).  For each it prints the wall time, the device's busy time (the
union of all kernel intervals, over all streams), the idle share, and the
device time by kernel class.  Chrome traces go to ``DIR`` (default
``chiprun_out/profile``).  Needs a card; fails without one.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402  (shares the pair's set-up)

CLASSES = (("flash_attention", ("flash_fwd",)),
           ("decode_attention", ("decode_split", "decode_combine")),
           ("matmul (cuBLAS)", ("gemm", "nvjet", "xmma", "cutlass", "sm90_")),
           ("other", ("",)))


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


def busy_us(intervals: list[tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def profile(torch, label: str, fn, out_dir: Path) -> dict:
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    trace = out_dir / f"{label}.json"
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        chip_smoke.fail(f"{label}: the profiler recorded no device kernels")
    by_class: dict[str, float] = {}
    for e in kernels:
        c = kernel_class(e["name"])
        by_class[c] = by_class.get(c, 0.0) + e["dur"]
    busy = busy_us([(e["ts"], e["ts"] + e["dur"]) for e in kernels])
    span = max(e["ts"] + e["dur"] for e in kernels) - min(e["ts"] for e in kernels)
    rec = {"wall_ms": 1e3 * wall, "kernel_span_ms": span / 1e3, "device_busy_ms": busy / 1e3,
           "idle_share_of_wall": 1.0 - busy / 1e6 / wall, "kernels": len(kernels),
           "device_ms_by_class": {c: v / 1e3 for c, v in sorted(by_class.items())}}
    chip_smoke.say(f"[profile] {label}: {json.dumps(rec)}")
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "profile"))
    args = ap.parse_args()
    import torch

    card = chip_smoke.phase_card(torch)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    from repro_torch.runtime.multitenant import FusedCoRunner

    _, tenants = chip_smoke.make_pair(torch)
    pre, dec = (t.name for t in tenants(("prefill", "decode")))

    def solo(which):
        t = tenants((which,))
        return lambda: FusedCoRunner(t, {t[0].name: 1}, quanta_per_cycle=1).run()

    recs = {
        "prefill_step": profile(torch, "prefill_step", solo("prefill"), out_dir),
        "decode_step": profile(torch, "decode_step", solo("decode"), out_dir),
        "co_run_macro_step": profile(
            torch, "co_run_macro_step",
            lambda: FusedCoRunner(tenants(("prefill", "decode")), {pre: 1, dec: 1}).run(),
            out_dir),
    }
    chip_smoke.say(json.dumps({"card": card, "profile": recs}))


if __name__ == "__main__":
    main()
