#!/usr/bin/env python3
"""Where the cycles of the flash kernel at heads of 64 go, statement by statement.

    python3 tools/flash_phases.py [--no-loads] [--sass FILE]

Builds ``src/repro_torch/csrc/flash_attention.cu`` twice into a temporary
directory: as it is, and with a ``clock64()`` read after every statement of
the consumer loop of ``flash_fwd_overlap_kernel`` (the softmax also fenced
on its registers, so that its cost is not carried into the next statement).
Each consumer warp sums the cycles between reads and adds them into a
device counter at its end.  At seamless-m4t's encoder shape (16 x 4096 x
4096, 16/16 heads of 64, non-causal, bf16) it prints the kernel's time
without and with the counters (CUDA events around 5 eager launches) and the
cycles a warp spends on each statement per kv tile, averaged over every
warp and tile after the first.  A warp's count includes the cycles in which
the other warps of its SM sub-partition issue, so the counts say where a
warp waits, not what each statement costs alone.

``--no-loads`` also times the kernel with the producer's TMA loads cut
after the first round of the ring (each later stage is released without
new data: a wrong result, for timing only), which shows whether the loop
waits on K and V.  ``--sass FILE`` writes ``cuobjdump -sass`` of the
uninstrumented build to FILE.  Needs an sm_90 card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SOURCE = ROOT / "src/repro_torch/csrc/flash_attention.cu"
LOOP = "    for (int kt = 1; kt < n_kt; ++kt) {\n"
EPILOGUE = "    __nv_bfloat16* ob = o + ((long)b * Sq * Hq + hq) * D;\n"
FIRST_LOAD = "        mbar_expect_tx(full + 8 * s, 2 * T::kKVBytes);\n"


def instrument(text: str) -> tuple[str, list[str]]:
    """The source with a cycle read after each statement of the consumer
    loop, and the statements' text."""
    a = text.index(LOOP) + len(LOOP)
    b = text.index("\n    }\n", a) + 1
    lines, names = [], []
    for line in text[a:b].splitlines(keepends=True):
        lines.append(line)
        code = line.split("//")[0].rstrip()
        if line.startswith("      ") and code.endswith(";"):
            if "softmax_tile_at" in code:
                lines.append("      fence_regs(sc);\n")
            lines.append(f"      PHASE_MARK({len(names)})\n")
            names.append(" ".join(code.split()))
    n = len(names)
    text = text[:a] + "".join(lines) + text[b:]
    kernel = text.index("flash_fwd_overlap_kernel(")
    start = text.index("    const float c = qk_scale_log2;\n", kernel)
    text = text[:start] + f"    unsigned long long cycles[{n}] = {{}};\n" \
        "    long long mark = clock64();\n" + text[start:]
    end = text.index(EPILOGUE, kernel)
    text = text[:end] + "    if (lane == 0) {\n" \
        f"      for (int i = 0; i < {n}; ++i) atomicAdd(&g_cycles[i], cycles[i]);\n" \
        f"      atomicAdd(&g_cycles[{n}], (unsigned long long)max(n_kt - 1, 0));\n" \
        "    }\n" + text[end:]
    text = text.replace(
        "namespace repro_torch {\n",
        f"namespace repro_torch {{\n__device__ unsigned long long g_cycles[{n + 1}];\n"
        "#define PHASE_MARK(i) { const long long now = clock64(); cycles[i] += now - mark; "
        "mark = now; }\n", 1)
    text += f"""
extern "C" int phases_read(unsigned long long* out) {{
  return (int)cudaMemcpyFromSymbol(out, repro_torch::g_cycles, sizeof(unsigned long long) * {n + 1});
}}
extern "C" int phases_reset() {{
  unsigned long long zero[{n + 1}] = {{}};
  return (int)cudaMemcpyToSymbol(repro_torch::g_cycles, zero, sizeof(zero));
}}
"""
    return text, names


def without_loads(text: str) -> str:
    """The producer releases each stage after the first round without loading it."""
    assert text.count(FIRST_LOAD) == 1
    return text.replace(FIRST_LOAD, "        if (it >= kStages) {\n"
                        "          mbar_arrive(full + 8 * s);\n          continue;\n        }\n"
                        + FIRST_LOAD)


def build(text: str, out_dir: Path):
    from repro_torch.kernels import build as kbuild

    out_dir.mkdir()
    for header in SOURCE.parent.glob("*.cuh"):
        (out_dir / header.name).write_text(header.read_text())
    (out_dir / "k.cu").write_text(text)
    lib = out_dir / "k.so"
    run = subprocess.run([kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-o", str(lib), str(out_dir / "k.cu")],
                         capture_output=True, text=True)
    if run.returncode != 0:
        raise SystemExit(f"flash_phases: nvcc failed:\n{(run.stdout + run.stderr)[-3000:]}")
    so = ctypes.CDLL(str(lib))
    so.flash_attention_launch.argtypes = kbuild._ENTRY["flash_attention"][1]
    so.flash_attention_launch.restype = ctypes.c_int
    return lib, so


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-loads", action="store_true")
    ap.add_argument("--sass", help="write the SASS of the uninstrumented build here")
    args = ap.parse_args()
    import torch

    from repro_torch.kernels import build as kbuild

    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        raise SystemExit("flash_phases: needs an sm_90 card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    B, S, H, D = 16, 4096, 16, 64
    gen = torch.Generator("cuda").manual_seed(12)
    q, k, v = (torch.randn((B, S, H, D), generator=gen, device="cuda").bfloat16() for _ in range(3))
    out = torch.empty_like(q)

    def ms(so, reps=5):
        def call():
            kbuild.check(so.flash_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, S, H, H, D, 0, 0,
                ctypes.c_float(D ** -0.5), torch.cuda.current_stream().cuda_stream), "flash_phases")

        for _ in range(3):
            call()
        torch.cuda.synchronize()
        if hasattr(so, "phases_reset"):
            so.phases_reset()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            call()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    text = SOURCE.read_text()
    probed, names = instrument(text)
    with tempfile.TemporaryDirectory() as tmp:
        lib, plain = build(text, Path(tmp) / "plain")
        if args.sass:
            sass = subprocess.run([str(Path(kbuild._nvcc()).parent / "cuobjdump"), "-sass", str(lib)],
                                  capture_output=True, text=True, check=True).stdout
            Path(args.sass).write_text(sass)
        _, counted = build(probed, Path(tmp) / "counted")
        t_plain, t_counted = ms(plain), ms(counted)
        cycles = (ctypes.c_ulonglong * (len(names) + 1))()
        kbuild.check(counted.phases_read(cycles), "flash_phases")
        tiles = max(cycles[len(names)], 1)
        total = sum(cycles[i] for i in range(len(names))) / tiles
        print(f"[phases] B={B} Sq=Skv={S} {H}/{H} heads of {D}: {t_plain:.4f} ms, "
              f"{t_counted:.4f} ms with the counters; {total:.0f} cycles a warp a kv tile  ({card})",
              flush=True)
        for i, name in enumerate(names):
            short = name if len(name) <= 72 else name[:69] + "..."
            print(f"    {cycles[i] / tiles:7.0f}  {short}", flush=True)
        if args.no_loads:
            _, unloaded = build(without_loads(text), Path(tmp) / "unloaded")
            print(f"[phases] with the loads cut after the ring's first round (wrong output): "
                  f"{ms(unloaded):.4f} ms, as built {ms(plain):.4f} ms  ({card})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
