#!/usr/bin/env python3
"""Peak device memory of ``chip_smoke.py`` phase 10 (b)'s train step:
seamless-m4t-large-v2 at its published width and depth on the zoo's job
``("seamless-m4t-large-v2", "train_4k", 8, 8)``, 32 x 512 tokens and
frames, and on that batch cut by each divisor given.

    python3 tools/train_memory.py [--div 1 2]

For each divisor, from the seeds of phase 10: the weights, the AdamW
state and one train step; prints the peak of ``max_memory_allocated`` and
the step's ms, or the allocation that failed.  Needs a card.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402  (phase 10's config and batch)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--div", type=int, nargs="+", default=[1, 2])
    args = ap.parse_args()
    import torch

    from repro_torch.models.model import init_params
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.runtime.steps import make_train_step

    card = chip_smoke.phase_card(torch)
    for div in args.div:
        chip_smoke.SEAMLESS_TRAIN_BATCH_DIV = div
        chip_smoke.free(torch)
        torch.cuda.reset_peak_memory_stats()
        cfg, batch = chip_smoke.seamless_train_batch(torch)
        shape = " x ".join(map(str, batch["tokens"].shape))
        params = init_params(cfg, seed=chip_smoke.FAMILY_TRAIN_SEED)
        opt = init_opt_state(params)
        state_gib = torch.cuda.memory_allocated() / 2**30
        step = make_train_step(cfg, OptConfig(**chip_smoke.LM_TRAIN_OPT))
        try:
            t0 = time.perf_counter()
            step(params, opt, batch)
            torch.cuda.synchronize()
            said = (f"peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB, "
                    f"{1e3 * (time.perf_counter() - t0):.1f} ms (the first step)")
        except torch.cuda.OutOfMemoryError as e:
            said = (f"out of memory at {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB "
                    f"allocated: {str(e).splitlines()[0]}")
        chip_smoke.say(f"[memory] {cfg.name} train step at {shape} tokens and frames (batch "
                       f"divisor {div}): weights, batch and AdamW state {state_gib:.1f} GiB; "
                       f"{said}  ({card})")
        del params, opt, batch
    chip_smoke.free(torch)


if __name__ == "__main__":
    main()
