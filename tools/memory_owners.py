#!/usr/bin/env python3
"""Who holds the card's memory when ``chip_smoke.py`` phase 10 starts.

    python3 tools/memory_owners.py

Runs ``chip_smoke.py``'s phases 0-9 in one process as its ``main`` does
(phase 5 (d), the xLSTM pair, left out for time) under the caching
allocator's memory history, then prints what is allocated and reserved,
the largest segments with the allocation sites of their live blocks, and
the live bytes by allocation site.  Phase 10 itself is not run: this is
the state its seamless train step meets.  Needs a card; about 10 min.
"""
from __future__ import annotations

import collections
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as c  # noqa: E402  (its phases)


def _site(block, depth: int) -> list[str]:
    return [f"{f['filename'].split('/')[-1]}:{f['line']}:{f['name']}"
            for f in block.get("frames", []) if f["filename"].endswith(".py")][:depth]


def main() -> None:
    import torch

    torch.cuda.memory._record_memory_history(max_entries=200000)
    t0 = time.perf_counter()
    card = c.phase_card(torch)
    c.phase_kernels(torch, card)
    c.phase_schedule(card)
    c.phase_pair(torch, card)
    c.phase_reference(torch)
    _, agent, _ = c.phase_train(torch, card)
    sched = c.start_schedule(agent)
    c.phase_lm_reference(torch)
    c.phase_lm_train(torch, card)
    c.phase_lm_pair(torch, card)
    c.phase_xlstm_reference(torch, card)
    trace, heap = c.phase_online(torch, card, agent)
    c.phase_vecsim(torch, card, agent, trace, heap)
    c.phase_families(torch, card)
    c.phase_audio(torch, card)
    c.free(torch)
    print(f"== at phase 10 start ({time.perf_counter() - t0:.0f} s): allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB, reserved "
          f"{torch.cuda.memory_reserved() / 2**30:.3f} GiB  ({card})", flush=True)
    segs = torch.cuda.memory._snapshot()["segments"]
    print(f"== {len(segs)} segments")
    for sg in sorted(segs, key=lambda s: -s["total_size"])[:25]:
        live = [b for b in sg["blocks"] if b["state"] == "active_allocated"]
        print(f"segment {sg['total_size'] / 2**20:10.1f} MiB pool {sg.get('segment_pool_id')} "
              f"stream {sg.get('stream')} allocated {sg['allocated_size'] / 2**20:.1f} MiB in "
              f"{len(live)} blocks", flush=True)
        for b in sorted(live, key=lambda b: -b["size"])[:3]:
            print(f"    block {b['size'] / 2**20:.2f} MiB  {' <- '.join(_site(b, 6))}", flush=True)
    by = collections.Counter()
    for sg in segs:
        for b in sg["blocks"]:
            if b["state"] == "active_allocated":
                by[" <- ".join(s.rsplit(":", 1)[0] for s in _site(b, 3))] += b["size"]
    print("== live bytes by allocation site")
    for k, v in by.most_common(20):
        print(f"  {v / 2**20:10.1f} MiB  {k}")
    sched["stop"]()


if __name__ == "__main__":
    main()
