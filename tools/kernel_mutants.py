#!/usr/bin/env python3
"""Show that ``chip_smoke.py``'s kernel checks fail kernels with planted faults.

    python3 tools/kernel_mutants.py

For each fault below it copies ``chip_smoke.py`` and ``src/`` of this
checkout into a temporary directory, plants the fault in the copy's CUDA
source (one or more sites, each of which must occur exactly once), and runs
the copy's phases 0 and 1 (build, then each kernel against its plain version
at the main path's shapes) on the card.  Each run must fail; the script
prints the failure and exits non-zero if a faulty kernel passes.  The
checkout itself is never changed.  Needs an sm_90 card and ``nvcc``.

The attention faults touch only the bfloat16 code.  The decode fault and
the first flash fault lose a small share of a long row's keys, where the
row's entries are near 1e-2: what an absolute bound of that order cannot
see.  The flash kernel's ring has a producer loop and a consumer loop, so
its lost tile is planted in both (the producer never loads it, the
consumers never wait for it).  The second flash fault leaves the tile that
crosses the causal diagonal unmasked: rows then see up to 127 later keys.
The first RMSNorm fault drops the scalar tail of each row from its sum of
squares, which moves a row by some 4e-4: the 8192 x 4096 rows have no tail
and the bf16 bound of 1e-2 cannot see it, so only the ragged f32 1000 x 4101
case can catch it.  The second leaves the last 8 rows of the ragged cases
unwritten; the 8192-row cases fill whole blocks and pass.
"""
from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# fault -> (source file, ((site, replacement), ...))
MUTANTS = {
    "decode_attention: the combine pass drops the first split of every bf16 row "
    "longer than one split": (
        "src/repro_torch/csrc/decode_attention.cu",
        (("    for (int s = 0; s < n_seen; ++s) {\n",
          "    for (int s = (sizeof(T) == 2 && n_seen > 1); s < n_seen; ++s) {\n"),)),
    "flash_attention: bf16 q tiles that see more than 16 kv tiles skip the last one": (
        "src/repro_torch/csrc/flash_attention.cu",
        (("    for (; kt < n_kt; ++kt) {\n",
          "    for (; kt < n_kt - (n_kt > 16); ++kt) {\n"),
         ("      for (int it = 0; it < n_kt; ++it) {\n",
          "      for (int it = 0; it < n_kt - (n_kt > 16); ++it) {\n"))),
    "flash_attention: the bf16 kv tile that crosses the causal diagonal is not masked": (
        "src/repro_torch/csrc/flash_attention.cu",
        (("      const bool masked = (k0 + kBK > Skv) || (causal && k0 + kBK - 1 > warp_row0);\n",
          "      const bool masked = (k0 + kBK > Skv);\n"),)),
    "rmsnorm: the scalar tail of each row is left out of its sum of squares": (
        "src/repro_torch/csrc/rmsnorm.cu",
        (("  for (int i = tail + lane; i < d; i += 32) {\n    const float v = to_f32(xr[i]);\n",
          "  for (int i = d + lane; i < d; i += 32) {\n    const float v = to_f32(xr[i]);\n"),)),
    "rmsnorm: the launch rounds the row count down to whole blocks, so the rows of a "
    "ragged last block are never normalized": (
        "src/repro_torch/csrc/rmsnorm.cu",
        (("  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;\n",
          "  const int blocks = rows / kWarpsPerBlock;\n"),)),
}

KERNEL_PHASES = ("import torch, chip_smoke as c; "
                 "c.phase_kernels(torch, c.phase_card(torch))")


def plant(text: str, sites, what: str, path: str) -> str:
    """``text`` with every site of a fault replaced; each site must occur
    exactly once, or the fault no longer has a place in the source."""
    for old, new in sites:
        if text.count(old) != 1:
            raise SystemExit(f"kernel_mutants: a site of '{what}' is not in {path} once")
        text = text.replace(old, new)
    return text


def main() -> int:
    caught = 0
    for what, (path, sites) in MUTANTS.items():
        with tempfile.TemporaryDirectory() as tmp:
            shutil.copy(ROOT / "chip_smoke.py", tmp)
            shutil.copytree(ROOT / "src", Path(tmp) / "src",
                            ignore=shutil.ignore_patterns("__pycache__"))
            src = Path(tmp) / path
            src.write_text(plant(src.read_text(), sites, what, path))
            run = subprocess.run([sys.executable, "-c", KERNEL_PHASES], cwd=tmp,
                                 capture_output=True, text=True, timeout=600)
        lines = [ln for ln in (run.stdout + run.stderr).splitlines()
                 if ln.startswith(("[1]", "chip_smoke"))]
        failed = run.returncode != 0 and any("FAILED" in ln for ln in lines)
        caught += failed
        print(f"{'caught' if failed else 'MISSED'}: {what}", flush=True)
        for ln in lines:
            print(f"    {ln}", flush=True)
    print(f"kernel_mutants: {caught} of {len(MUTANTS)} planted faults caught", flush=True)
    return 0 if caught == len(MUTANTS) else 1


if __name__ == "__main__":
    raise SystemExit(main())
