#!/usr/bin/env python3
"""Time design variants of the bf16 flash kernel against each other on one card.

    python3 tools/flash_variants.py [--parent DIR]

Each variant is ``src/repro_torch/csrc/flash_attention.cu`` of this checkout
with a few lines replaced (the ``VARIANTS`` table below), built with the
package's own nvcc flags into a temporary directory and called through its
C launcher.  ``--parent DIR`` adds the kernel of another checkout (for
example a ``git archive`` of the parent commit) as one more variant.  At
the llama3-8b prefill shape (B=1, Sq=Skv=8192, 32/8 heads of 128, causal,
bf16) every variant is first held against ``flash_attention_plain`` (each
output row to ||out - ref|| / ||ref|| <= 1e-2), then timed with CUDA events
in eight rounds, every other one in reverse order, so that a drift of the
card shows as a spread between the rounds; the median is the variant's
time.  It also times the host's side of a
launch (three tensor maps encoded, the kernel enqueued) against the f32
path's, which encodes none.  The checkout is never changed.  Needs an
sm_90 card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SOURCE = "src/repro_torch/csrc/flash_attention.cu"
NO_PINGPONG = [
    ('  asm volatile("bar.sync %0, 256;\\n" ::"r"(id) : "memory");\n', ""),
    ('  asm volatile("bar.arrive %0, 256;\\n" ::"r"(id) : "memory");\n', ""),
]
# name -> replacements (old, new) in the source; each old string occurs once
VARIANTS = {
    "as committed (ping-pong, 2 stages)": [],
    "no ping-pong": NO_PINGPONG,
    "3 stages": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
    "exp2f in the softmax": [('  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));\n',
                              "  y = exp2f(x);\n")],
}
SHAPE = dict(B=1, Sq=8192, Skv=8192, Hq=32, Hkv=8, D=128)
ROUNDS, REPS = 8, 20   # timed rounds (every other one in reverse order), launches a round


def build_variant(torch_build, text: str, out_dir: Path, name: str) -> tuple[Path, float, str]:
    """Compile one variant's source (beside a copy of the shared header)."""
    src = out_dir / f"{name}.cu"
    src.write_text(text)
    for header in torch_build.CSRC.glob("*.cuh"):
        (out_dir / header.name).write_text(header.read_text())
    lib = out_dir / f"{name}.so"
    t0 = time.perf_counter()
    run = subprocess.run([torch_build._nvcc(), *torch_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                         capture_output=True, text=True)
    if run.returncode != 0:
        raise SystemExit(f"flash_variants: nvcc failed for {name}:\n{run.stdout}{run.stderr}")
    report = " | ".join(ln.strip() for ln in (run.stdout + run.stderr).splitlines()
                        if any(w in ln for w in ("registers", "spill", "arning")))
    return lib, time.perf_counter() - t0, report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="root of another checkout whose kernel to time as well")
    args = ap.parse_args()
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention_plain

    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        raise SystemExit("flash_variants: needs an sm_90 card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    base = (ROOT / SOURCE).read_text()
    sources = {}
    for name, edits in VARIANTS.items():
        text = base
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"flash_variants: the site {old!r} of '{name}' is not in {SOURCE}")
            text = text.replace(old, new)
        sources[name] = text
    if args.parent:
        sources[f"parent ({args.parent})"] = (Path(args.parent) / SOURCE).read_text()

    symbol, argtypes = build._ENTRY["flash_attention"]
    fns = {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, text) in enumerate(sources.items()):
            lib, secs, report = build_variant(build, text, Path(tmp), f"v{i}")
            fn = getattr(ctypes.CDLL(str(lib)), symbol)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            fns[name] = fn
            print(f"[build] {name}: {secs:.1f} s; {report}", flush=True)

        s = SHAPE
        gen = torch.Generator("cuda").manual_seed(12)
        q = torch.randn((s["B"], s["Sq"], s["Hq"], s["D"]), generator=gen, device="cuda").bfloat16()
        k = torch.randn((s["B"], s["Skv"], s["Hkv"], s["D"]), generator=gen,
                        device="cuda").bfloat16()
        v = torch.randn_like(k)
        out = torch.empty_like(q)
        scale = ctypes.c_float(s["D"] ** -0.5)

        def call(fn, q=q, k=k, v=v, out=out, dtype=0):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), q.shape[0],
                     q.shape[1], k.shape[1], q.shape[2], k.shape[2], q.shape[3], dtype, 1, scale,
                     torch.cuda.current_stream().cuda_stream)
            build.check(err, "flash_variants")

        ref = flash_attention_plain(q, k, v, causal=True).float()
        errs = {}
        for name, fn in fns.items():
            out.zero_()
            call(fn)
            torch.cuda.synchronize()
            diff = (out.float() - ref).flatten(0, -2).norm(dim=-1)
            rel = (diff / ref.flatten(0, -2).norm(dim=-1).clamp_min(1e-30)).max().item()
            errs[name] = rel
            if not rel <= 1e-2:
                raise SystemExit(f"flash_variants: {name}: row relative error {rel:.3e}")

        def time_ms(fn) -> float:
            call(fn)
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(REPS):
                call(fn)
            b.record()
            b.synchronize()
            return a.elapsed_time(b) / REPS

        times = {name: [] for name in fns}
        for r in range(ROUNDS):
            for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
                times[name].append(time_ms(fns[name]))
        for name in fns:
            print(f"[time] {name}: median {statistics.median(times[name]):.4f} ms, rounds "
                  f"{' / '.join(f'{t:.4f}' for t in times[name])}, row error "
                  f"{errs[name]:.2e}  ({card})", flush=True)

        # host side of one launch at a small shape (the card never falls behind)
        small = [torch.randn((1, 128, 8, 128), device="cuda", dtype=dt) for dt in
                 (torch.bfloat16, torch.float32)]
        fn = fns[next(iter(fns))]
        host = {}
        for dt, x in zip(("bfloat16", "float32"), small):
            kv = x[:, :, :2].contiguous()
            o = torch.empty_like(x)
            code = 0 if dt == "bfloat16" else 1
            for _ in range(3):
                call(fn, x, kv, kv, o, code)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                call(fn, x, kv, kv, o, code)
            host[dt] = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
        print(f"[host] C launcher, host us per call: bf16 {host['bfloat16']:.2f} (three tensor "
              f"maps encoded), f32 {host['float32']:.2f} (none)", flush=True)
    print(json.dumps({"card": card, "ms": times, "row_err": errs, "host_us": host}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
