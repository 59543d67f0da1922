#!/usr/bin/env python3
"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs from the root of a checkout that holds ``BENCHMARK.json``,
``portbench/`` and the program (``src/repro_torch``).  Needs a CUDA card;
prints one JSON object as the last line of standard output, with the
numbers the correctness check compared as the last lines of standard
error.  ``--control 1`` also reads the control (the reference in float8 in
the program's place) and prints its numbers under ``control``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# build caches at fixed paths inside the checkout; the program's kernels
# build into build/repro_torch/ there by themselves
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "portbench" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "portbench" / "torch_extensions")
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    ap.add_argument("--readings", help="write every answer's reading (and the control's) "
                    "to this JSON file, to set limits from")
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    spec = harness.load_spec(args.workload)
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    say = lambda msg: print(msg, file=sys.stderr, flush=True)   # noqa: E731
    say(f"portbench: {args.workload} seed {args.seed} on {harness.power_limit()} "
        f"(name, power limit)")
    out = harness.run(spec, args.seed, args.seconds, bool(args.trace), "cuda",
                      control=bool(args.control), log=say, readings=args.readings)
    found = harness.forbidden_modules()
    if found:
        say(f"portbench: the process loaded {found}; the benchmark runs the port alone")
        return 4
    for name, ch in out["checks"].items():
        say(f"check {name} {ch['stat']} {ch['value']!r} limit {ch['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
