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

The attention faults touch only the bfloat16 code.  The decode faults
lose part of a long row's keys, where the row's entries are near 1e-2: what
an absolute bound of that order cannot see.  The first leaves the first
partial out of the accumulators the combine pass sums for each pair that
has more than one (its weight stays in the denominator); the
second loses the partial of a share's last pair where that is not its
first (the slot keeps whatever the workspace held); the third shortens
every share of more than 8 tiles
by its last tile in the one loop count that both the producer and the
consumer warp follow.  The flash kernel's ring has a producer loop and a
consumer loop, so its lost tile is planted in both (the producer never loads
it, the consumers never wait for it).  The second flash fault leaves the
tile that crosses the causal diagonal unmasked: rows then see up to 127
later keys.  The first RMSNorm fault drops the scalar tail of each row from
its sum of squares, which moves a row by some 4e-4: the 8192 x 4096 rows
have no tail and the bf16 bound of 1e-2 cannot see it, so only the ragged
f32 1000 x 4101 case can catch it.  The second leaves the rows of a ragged
last block unwritten (the 4095 x 1024 case, two rows a block); the third
leaves each thread's last register vector out of its row's sum.
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
        (("  for (long i = i_lo; i <= i_hi; ++i) {\n",
          "  for (long i = i_lo + (i_hi > i_lo); i <= i_hi; ++i) {\n"),)),
    "decode_attention: a bf16 block whose share crosses into another pair loses its "
    "second segment's partial": (
        "src/repro_torch/csrc/decode_attention.cu",
        (("  flush();\n}\n",
          "  if (walk_to(lengths, Hkv, Smax, t_begin).b == seg_b && "
          "walk_to(lengths, Hkv, Smax, t_begin).h == seg_h) flush();\n}\n"),)),
    "decode_attention: the bf16 producer skips the last tile of a share longer than "
    "8 tiles, and the consumer never waits for it": (
        "src/repro_torch/csrc/decode_attention.cu",
        (("  const int n_it = (int)(t_end - t_begin);\n",
          "  const int n_it = (int)(t_end - t_begin) - (t_end - t_begin > 8);\n"),)),
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
        (("    for (int i = tail + t; i < d; i += tpr) {\n      const float v = to_f32(xr[i]);\n",
          "    for (int i = d + t; i < d; i += tpr) {\n      const float v = to_f32(xr[i]);\n"),)),
    "rmsnorm: the launch rounds the row count down to whole blocks, so the rows of a "
    "ragged last block are never normalized": (
        "src/repro_torch/csrc/rmsnorm.cu",
        (("  const int blocks = (rows + rows_per_block - 1) / rows_per_block;\n",
          "  const int blocks = rows / rows_per_block;\n"),)),
    "rmsnorm: the register path leaves each lane's last vector out of its sum of squares": (
        "src/repro_torch/csrc/rmsnorm.cu",
        (("  for (int u = 0; u < VPL; ++u) {\n    if (live && t + u * tpr < nvec) {\n",
          "  for (int u = 0; u < VPL - 1; ++u) {\n    if (live && t + u * tpr < nvec) {\n"),)),
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
