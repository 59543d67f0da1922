#!/usr/bin/env python3
"""Time design variants of one of the port's CUDA kernels against each other on one card.

    python3 tools/kernel_variants.py --kernel {flash_attention,decode_attention,rmsnorm}
                                     [--parent DIR]

Each variant is the kernel's source in ``src/repro_torch/csrc`` of this
checkout with a few lines replaced (the ``variants`` of ``KERNELS`` below),
built with the package's own nvcc flags into a temporary directory and
called through its C launcher.  ``--parent DIR`` adds the kernel of another
checkout as one more variant, called as that checkout's wrapper calls it;
to hold a change against the commit before it, unpack that commit's
sources into a git-ignored directory of this checkout first:

    mkdir -p experiments/parent
    git archive HEAD~1 src/repro_torch | tar -x -C experiments/parent
    python3 tools/kernel_variants.py --kernel flash_attention --parent experiments/parent

(the ``tar`` lands ``experiments/parent/src/repro_torch``).  A variant
that does not build, or does not match the plain version, is reported and
left out of the timing, and the run then exits non-zero.  At each of the
kernel's shapes (the main path's, from ``chip_smoke.py`` phase 1) every
variant is first held against the plain version (each output row to
||out - ref|| / ||ref|| <= 1e-2 in bf16), then timed in eight rounds, every
other one in reverse order, so that a drift of the card shows as a spread
between the rounds; a round replays the variant's launches from a CUDA
graph and times them with CUDA events (device time: a launch from Python
costs more host time than a short kernel takes); the median is the
variant's time.
(A variant listed as ``unchecked`` computes only part of the function, to
time that part; its row error is printed but not held to the bound.)  For
the flash kernel it also times the host's side of a launch (three
tensor maps encoded, the kernel enqueued) against the f32 path's, which
encodes none.  The checkout is never changed.  Needs an sm_90 card and
nvcc.
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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

ROUNDS = 8   # timed rounds, every other one in reverse order
ROW_TOL = 1e-2

# kernel -> its source, its variants (name -> replacements (old, new), each
# old string occurring once), and the launches timed in a round
KERNELS = {
    "flash_attention": {
        "source": "src/repro_torch/csrc/flash_attention.cu",
        # the choices of the kernel at heads of 64 (``Fwd<64>``), and the two
        # that could carry to heads of 128 (its own kernel) timed there
        "variants": {
            "as committed (D = 64: 3 warpgroups where the grid fills the card twice, else 2; "
            "ping-pong; 3 or 4 stages; 2^x of 1 n-block in 8 on the FMA pipe at 2)": [],
            "D = 64: 2 warpgroups on every grid": [(
                "kMaxWG = 3;       // consumer warpgroups of 64 q rows on a large grid",
                "kMaxWG = 2;       // consumer warpgroups of 64 q rows on a large grid")],
            "D = 64: 2 stages at 3 warpgroups": [(
                "kStages3 = 3;     // K/V ring depth with 3 consumer warpgroups",
                "kStages3 = 2;     // K/V ring depth with 3 consumer warpgroups")],
            "D = 64: 3 stages at 2 warpgroups": [(
                "kStages2 = 4;     // K/V ring depth with 2 consumer warpgroups",
                "kStages2 = 3;     // K/V ring depth with 2 consumer warpgroups")],
            "D = 64: no ping-pong": [("  named_bar_sync(1 + wg);\n}", "}"),
                                     ("  named_bar_arrive(1 + (wg + 1) % W);\n}", "}")],
            "D = 64: 2^x on the exp unit only (at 2 warpgroups)": [(
                "  static constexpr int kPoly2 = 8;", "  static constexpr int kPoly2 = 0;")],
            "D = 64: 2^x of 1 n-block in 8 on the FMA pipe at 3 warpgroups": [(
                "  static constexpr int kPoly3 = 0;", "  static constexpr int kPoly3 = 8;")],
            "D = 64: 2^x of 1 n-block in 4 on the FMA pipe at 3 warpgroups": [(
                "  static constexpr int kPoly3 = 0;", "  static constexpr int kPoly3 = 4;")],
            "D = 64: rescale decided by each thread": [(
                "  if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {",
                "  if (alpha[0] != 1.f || alpha[1] != 1.f) {")],
            "D = 64: heads the grid's fast axis (the D = 128 kernel's order)": [
                ("  const int bh = blockIdx.y, b = bh / Hq, hq = bh % Hq, hk = hq / (Hq / Hkv);\n"
                 "  const int q0 = (gridDim.x - 1 - blockIdx.x) * T::kBQ;\n",
                 "  const int bh = blockIdx.x, b = bh / Hq, hq = bh % Hq, hk = hq / (Hq / Hkv);\n"
                 "  const int q0 = (gridDim.y - 1 - blockIdx.y) * T::kBQ;\n"),
                ("  dim3 grid((Sq + T::kBQ - 1) / T::kBQ, B * Hq);\n",
                 "  dim3 grid(B * Hq, (Sq + T::kBQ - 1) / T::kBQ);\n")],
            "D = 128: q tiles the grid's fast axis": [
                ("  const int bh = blockIdx.x, b = bh / Hq, hq = bh % Hq, hk = hq / (Hq / Hkv);\n"
                 "  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // most work first\n",
                 "  const int bh = blockIdx.y, b = bh / Hq, hq = bh % Hq, hk = hq / (Hq / Hkv);\n"
                 "  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // most work first\n"),
                ("  dim3 grid(B * Hq, (Sq + kBQ - 1) / kBQ);\n",
                 "  dim3 grid((Sq + kBQ - 1) / kBQ, B * Hq);\n")],
        },
        "reps": 20,
    },
    "decode_attention": {
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "variants": {
            "as committed (3 stages; 4 blocks an SM at D = 128, 8 at D = 64)": [],
            "4 stages, 3 blocks an SM": [("constexpr int kStages = 3;",
                                          "constexpr int kStages = 4;")],
            "2 stages": [("constexpr int kStages = 3;", "constexpr int kStages = 2;")],
            "6 stages": [("constexpr int kStages = 3;", "constexpr int kStages = 6;")],
            "4 blocks an SM": [],
            "8 blocks an SM": [],
            "2 stages, 12 blocks an SM": [("constexpr int kStages = 3;",
                                           "constexpr int kStages = 2;")],
            "combine launched after the split (no dependent launch)": [
                ("constexpr bool kDependentLaunch = true;", "constexpr bool kDependentLaunch = false;")],
            # the first launch's share of the call: the combine is not launched
            "split kernel alone": [("  return (int)cudaLaunchKernelEx(&cfg,",
                                    "  if (n_blocks > 0) return 0;\n"
                                    "  return (int)cudaLaunchKernelEx(&cfg,")],
        },
        # blocks an SM the grid is sized for, where a variant's differs
        "blocks_per_sm": {"4 stages, 3 blocks an SM": 3, "4 blocks an SM": 4, "8 blocks an SM": 8,
                          "2 stages, 12 blocks an SM": 12},
        # variants timed but not held against the plain version
        "unchecked": ("split kernel alone",),
        "reps": 50,
    },
    "rmsnorm": {
        "source": "src/repro_torch/csrc/rmsnorm.cu",
        "variants": {
            "as committed": [],
            "no widening for short slabs": [
                ("    while (tpr < kThreads && (long)rows * tpr < kFillThreads) tpr *= 2;\n", ""),
            ],
            "two-pass path everywhere": [
                ("  if (nv <= kRegVectors) {\n", "  if (false) {\n"),
            ],
            "streaming accesses at every size": [
                ("  if ((long)rows * d * (long)sizeof(T) > kStreamBytes)\n", "  if (true)\n")],
            "cached accesses at every size": [
                ("  if ((long)rows * d * (long)sizeof(T) > kStreamBytes)\n", "  if (false)\n")],
        },
        "reps": 50,
    },
}


def build_variant(build, text: str, headers: Path, out_dir: Path) -> tuple[Path, float, str]:
    """Compile one variant's source into ``out_dir``, beside copies of the
    shared headers of the checkout it comes from."""
    out_dir.mkdir()
    src = out_dir / "v.cu"
    src.write_text(text)
    for header in headers.glob("*.cuh"):
        (out_dir / header.name).write_text(header.read_text())
    lib = out_dir / "v.so"
    t0 = time.perf_counter()
    run = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
                         capture_output=True, text=True)
    if run.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{(run.stdout + run.stderr)[-3000:]}")
    report = " | ".join(build.ptxas_report(run.stdout + run.stderr))
    return lib, time.perf_counter() - t0, report


def flash_cases(torch, build):
    """The llama3-8b prefill shape: B=1, Sq=Skv=8192, 32/8 heads, causal;
    seamless-m4t's encoder: B=16, Sq=Skv=4096, 16/16 heads of 64,
    non-causal, and its cross-attention in teacher forcing, B=2, 512
    queries against 4096 frames."""
    from repro_torch.kernels.flash_attention import flash_attention_plain

    shapes = {"B=1 Sq=Skv=8192 32/8 heads causal": (1, 8192, 8192, 32, 8, 128, True),
              "B=16 Sq=Skv=4096 16/16 heads of 64 non-causal": (16, 4096, 4096, 16, 16, 64, False),
              "B=2 Sq=512 Skv=4096 16/16 heads of 64 non-causal": (2, 512, 4096, 16, 16, 64,
                                                                   False)}
    cases = {}
    for case, (B, sq, skv, hq, hkv, d, causal) in shapes.items():
        gen = torch.Generator("cuda").manual_seed(12)
        q = torch.randn((B, sq, hq, d), generator=gen, device="cuda").bfloat16()
        k = torch.randn((B, skv, hkv, d), generator=gen, device="cuda").bfloat16()
        v = torch.randn_like(k)
        out = torch.empty_like(q)

        def call(fn, name, q=q, k=k, v=v, out=out, causal=causal, dtype=0):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), q.shape[0],
                     q.shape[1], k.shape[1], q.shape[2], k.shape[2], q.shape[3], dtype,
                     int(causal), ctypes.c_float(q.shape[3] ** -0.5),
                     torch.cuda.current_stream().cuda_stream)
            build.check(err, "kernel_variants")
            return out

        cases[case] = (call, flash_attention_plain(q, k, v, causal=causal))
    return cases


def decode_cases(torch, build, parent_split_rule: str | None, blocks_per_sm: dict):
    """The phase-1 lengths and the co-run pair's, B=4, Smax 32768, 32/8
    heads; seamless-m4t's cross-attention decode, B=16, Smax 4096, 16/16
    heads of 64, at phase 1's ragged lengths."""
    from repro_torch.kernels.decode_attention import ops

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    shapes = {f"B=4 Smax=32768 32/8 heads lengths={lengths}": (lengths, 32768, 32, 8, 128)
              for lengths in ([32760, 20001, 1, 12345], [32760, 24577, 16001, 8191])}
    shapes["B=16 Smax=4096 16/16 heads of 64, phase 1's lengths"] = (
        chip_smoke.D64_CROSS_LENGTHS, 4096, 16, 16, 64)
    cases = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for case, (lengths, smax, hq, hkv, d) in shapes.items():
        gen = torch.Generator("cuda").manual_seed(11)
        B = len(lengths)
        q = torch.randn((B, hq, d), generator=gen, device="cuda").bfloat16()
        k = torch.randn((B, smax, hkv, d), generator=gen, device="cuda").bfloat16()
        v = torch.randn((B, smax, hkv, d), generator=gen, device="cuda").bfloat16()
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        out = torch.empty_like(q)
        # enough workspace for either split rule
        acc = torch.empty((B * hkv * 64 * 4 * d + 8 * sms * 4 * d,), device="cuda")
        ml = torch.empty((acc.numel() // 64,), device="cuda")

        def call(fn, name, q=q, k=k, v=v, lens=lens, out=out, acc=acc, ml=ml, B=B, smax=smax,
                 hq=hq, hkv=hkv, d=d):
            if name.startswith("parent") and parent_split_rule == "chunks":
                n_split, chunk = -(-smax // 512), 512   # 8 tiles of 64 keys a block
            else:
                n_split = min(blocks_per_sm.get(name, ops._BLOCKS_PER_SM[d]) * sms,
                              B * hkv * -(-smax // ops._TILE[torch.bfloat16]))
                chunk = ops._TILE[torch.bfloat16]
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), out.data_ptr(),
                     acc.data_ptr(), ml.data_ptr(), B, hq, hkv, smax, d, 0, n_split, chunk,
                     ctypes.c_float(d ** -0.5), torch.cuda.current_stream().cuda_stream)
            build.check(err, "kernel_variants")
            return out

        cases[case] = (call, ops.decode_attention_plain(q, k, v, lens))
    return cases


def rmsnorm_cases(torch, build):
    """8192 x 4096 (the prefill tenant's residual stream) and 1000 x 4100, bf16."""
    from repro_torch.kernels.rmsnorm import rmsnorm_plain

    cases = {}
    for rows, d in ((8192, 4096), (1000, 4100)):
        gen = torch.Generator("cuda").manual_seed(13)
        x = torch.randn((rows, d), generator=gen, device="cuda").bfloat16()
        scale = torch.randn((d,), generator=gen, device="cuda").bfloat16()
        out = torch.empty_like(x)

        def call(fn, name, x=x, scale=scale, out=out, rows=rows, d=d):
            err = fn(x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d, 0, 0,
                     ctypes.c_float(1e-5), 1, torch.cuda.current_stream().cuda_stream)
            build.check(err, "kernel_variants")
            return out

        cases[f"{rows} x {d}"] = (call, rmsnorm_plain(x, scale, eps=1e-5))
    return cases


def host_launch_us(torch, build, fn) -> dict:
    """Host side of one flash launch at a small shape (the card never falls
    behind): bf16 encodes three tensor maps, f32 none."""
    host = {}
    for dt, code in ((torch.bfloat16, 0), (torch.float32, 1)):
        x = torch.randn((1, 128, 8, 128), device="cuda", dtype=dt)
        kv = x[:, :, :2].contiguous()
        o = torch.empty_like(x)

        def call():
            build.check(fn(x.data_ptr(), kv.data_ptr(), kv.data_ptr(), o.data_ptr(), 1, 128,
                           128, 8, 2, 128, code, 1, ctypes.c_float(0.1),
                           torch.cuda.current_stream().cuda_stream), "kernel_variants")

        for _ in range(3):
            call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            call()
        host[str(dt).split(".")[1]] = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
    return host


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", required=True, choices=sorted(KERNELS))
    ap.add_argument("--parent", help="root of another checkout whose kernel to time as well")
    args = ap.parse_args()
    import torch

    from repro_torch.kernels import build

    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        raise SystemExit("kernel_variants: needs an sm_90 card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    spec = KERNELS[args.kernel]
    base = (ROOT / spec["source"]).read_text()
    sources = {}
    for name, edits in spec["variants"].items():
        text = base
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"kernel_variants: the site {old!r} of '{name}' is not in "
                                 f"{spec['source']} once")
            text = text.replace(old, new)
        sources[name] = text
    parent_rule = None
    if args.parent:
        parent = Path(args.parent)
        sources[f"parent ({args.parent})"] = (parent / spec["source"]).read_text()
        ops = parent / "src/repro_torch/kernels/decode_attention/ops.py"
        parent_rule = "shares" if "def grid_blocks" in ops.read_text() else "chunks"

    symbol, argtypes = build._ENTRY[args.kernel]
    fns, failed = {}, []
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(len(sources)) as pool:
        # every variant's nvcc at once
        builds = {name: pool.submit(build_variant, build, text,
                                    (Path(args.parent) if name.startswith("parent") else ROOT)
                                    / "src/repro_torch/csrc", Path(tmp) / f"v{i}")
                  for i, (name, text) in enumerate(sources.items())}
        for name, job in builds.items():
            try:
                lib, secs, report = job.result()
            except RuntimeError as e:
                print(f"[build] {name}: does not build; {e}", flush=True)
                failed.append(name)
                continue
            fn = getattr(ctypes.CDLL(str(lib)), symbol)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            fns[name] = fn
            print(f"[build] {name}: {secs:.1f} s; {report}", flush=True)

        if args.kernel == "flash_attention":
            cases = flash_cases(torch, build)
        elif args.kernel == "decode_attention":
            cases = decode_cases(torch, build, parent_rule, spec.get("blocks_per_sm", {}))
        else:
            cases = rmsnorm_cases(torch, build)

        result = {"card": card, "kernel": args.kernel, "cases": {}}
        for case, (call, ref) in cases.items():
            errs, runs = {}, dict(fns)
            for name, fn in fns.items():
                try:
                    out = call(fn, name)
                except (RuntimeError, ValueError) as e:
                    # a ring deeper than shared memory holds; a parent kernel without D = 64
                    print(f"[time] {args.kernel} {case}: {name}: does not launch ({e})",
                          flush=True)
                    del runs[name]
                    continue
                torch.cuda.synchronize()
                diff = (out.float() - ref.float()).flatten(0, -2).norm(dim=-1)
                size = ref.float().flatten(0, -2).norm(dim=-1)
                rel = torch.where(diff == 0, torch.zeros_like(diff), diff / size).max().item()
                errs[name] = rel
                if not rel <= ROW_TOL and name not in spec.get("unchecked", ()):
                    failed.append(name)
                    print(f"[time] {args.kernel} {case}: {name}: WRONG, row relative error "
                          f"{rel:.3e}", flush=True)
                    del runs[name]

            def time_ms(fn, name) -> float:
                """Device time of one launch: ``reps`` launches replayed from a
                CUDA graph, so that the host's side is not in it."""
                call(fn, name)
                torch.cuda.synchronize()
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    for _ in range(spec["reps"]):
                        call(fn, name)
                graph.replay()
                torch.cuda.synchronize()
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                graph.replay()
                b.record()
                b.synchronize()
                return a.elapsed_time(b) / spec["reps"]

            times = {name: [] for name in runs}
            for r in range(ROUNDS):
                for name in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
                    times[name].append(time_ms(runs[name], name))
            for name in runs:
                print(f"[time] {args.kernel} {case}: {name}: median "
                      f"{statistics.median(times[name]):.4f} ms, rounds "
                      f"{' / '.join(f'{t:.4f}' for t in times[name])}, row error "
                      f"{errs[name]:.2e}  ({card})", flush=True)
            result["cases"][case] = {"ms": times, "row_err": errs}

        if args.kernel == "flash_attention":
            host = host_launch_us(torch, build, fns[next(iter(fns))])
            print(f"[host] C launcher, host us per call: bf16 {host['bfloat16']:.2f} (three "
                  f"tensor maps encoded), f32 {host['float32']:.2f} (none)", flush=True)
            result["host_us"] = host
    print(json.dumps(result), flush=True)
    if failed:
        print(f"kernel_variants: failed: {', '.join(dict.fromkeys(failed))}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
