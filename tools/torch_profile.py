#!/usr/bin/env python3
"""Where the device time of the port's two paths goes.

    python3 tools/torch_profile.py [--out DIR]

First the co-scheduler's training engine (``core/train.py``) at
``chip_smoke.py``'s phase 4 settings (16 envs, window 8): after warm-up
steps that fill the replay ring past one batch, 5 engine steps run under
``torch.profiler``, once with the perfmodel replayed from its CUDA graph
(the training path) and once launched kernel by kernel.  Then the pair of
``chip_smoke.py`` (prefill 1 x 8192 tokens, decode batch 4 against a
32768-slot cache, full width, bf16): one prefill step alone, one decode
step alone, and one co-run macro-step of ``FusedCoRunner`` (both tenants on
their streams).  For each run it prints the wall time, the device's busy
time (the union of all kernel intervals, over all streams), the idle share,
the kernels the device ran, the host's launch calls (kernels, graphs,
copies), and the device time by kernel class.  Chrome traces go to ``DIR``
(default ``chiprun_out/profile``).  Needs a card; fails without one.
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

# host-side runtime calls that put work on the device
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync",
                "cuLaunchKernel")
TRAIN_STEPS = 5
CLASSES = (("flash_attention", ("flash_fwd",)),
           ("decode_attention", ("decode_split", "decode_combine")),
           ("rmsnorm", ("rmsnorm_kernel",)),
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


def profile(torch, label: str, fn, out_dir: Path, keep: bool = True) -> dict:
    """Run ``fn`` under the profiler; its trace stays in ``out_dir`` when
    ``keep`` (a training trace holds some 10^5 kernels and is not kept)."""
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
    if not keep:
        trace.unlink()
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        chip_smoke.fail(f"{label}: the profiler recorded no device kernels")
    by_class: dict[str, float] = {}
    for e in kernels:
        c = kernel_class(e["name"])
        by_class[c] = by_class.get(c, 0.0) + e["dur"]
    busy = busy_us([(e["ts"], e["ts"] + e["dur"]) for e in kernels])
    span = max(e["ts"] + e["dur"] for e in kernels) - min(e["ts"] for e in kernels)
    launch_calls = {}
    for e in events:
        if e.get("cat") == "cuda_runtime" and e["name"].startswith(LAUNCH_CALLS):
            launch_calls[e["name"]] = launch_calls.get(e["name"], 0) + 1
    rec = {"wall_ms": 1e3 * wall, "kernel_span_ms": span / 1e3, "device_busy_ms": busy / 1e3,
           "idle_share_of_wall": 1.0 - busy / 1e6 / wall, "kernels": len(kernels),
           "host_launch_calls": dict(sorted(launch_calls.items())),
           "device_ms_by_class": {c: v / 1e3 for c, v in sorted(by_class.items())}}
    chip_smoke.say(f"[profile] {label}: {json.dumps(rec)}")
    return rec


def train_engine(torch, cuda_graphs: bool):
    """The training engine at phase 4's settings, its ring filled past one
    batch so every profiled step runs its update.  ``cuda_graphs=False``
    swaps the environment's perfmodel for its eager launches, to compare."""
    import functools

    import numpy as np

    from repro_torch.core import EnvConfig, make_zoo
    from repro_torch.core.agent import DQNAgent
    from repro_torch.core.env import VecCoScheduleEnv
    from repro_torch.core.perfmodel_vec import group_metrics
    from repro_torch.core.train import _engine_for, _train_queues, heldout_split

    zoo = make_zoo()
    env_cfg = EnvConfig(window=chip_smoke.TRAIN_WINDOW, c_max=4)
    cfg = chip_smoke.train_config()
    venv = VecCoScheduleEnv(env_cfg, "cuda")
    if not cuda_graphs:
        venv._metrics = functools.partial(group_metrics, venv.table)
    agent = DQNAgent(venv.state_dim, venv.n_actions, cfg.dqn, device="cuda")
    eng = _engine_for(venv, cfg, agent, torch.Generator("cuda").manual_seed(0))
    queues = _train_queues(zoo, env_cfg, cfg, heldout_split(zoo), np.random.default_rng(0))
    eng.start_segment(venv.queue_batch(queues[:cfg.batch_envs]))
    while eng.replay.size < 2 * cfg.dqn.batch_size:
        eng.step()
    return eng


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "profile"))
    args = ap.parse_args()
    import torch

    card = chip_smoke.phase_card(torch)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    from repro_torch.runtime.multitenant import FusedCoRunner

    recs = {}
    for graphs in (True, False):
        label = f"train_{TRAIN_STEPS}_engine_steps_{'graphed' if graphs else 'eager'}"
        eng = train_engine(torch, graphs)
        recs[label] = profile(torch, label, lambda: [eng.step() for _ in range(TRAIN_STEPS)],
                              out_dir, keep=False)
        del eng

    _, tenants = chip_smoke.make_pair(torch)
    pre, dec = (t.name for t in tenants(("prefill", "decode")))

    def solo(which):
        t = tenants((which,))
        return lambda: FusedCoRunner(t, {t[0].name: 1}, quanta_per_cycle=1).run()

    recs.update({
        "prefill_step": profile(torch, "prefill_step", solo("prefill"), out_dir),
        "decode_step": profile(torch, "decode_step", solo("decode"), out_dir),
        "co_run_macro_step": profile(
            torch, "co_run_macro_step",
            lambda: FusedCoRunner(tenants(("prefill", "decode")), {pre: 1, dec: 1}).run(),
            out_dir),
    })
    chip_smoke.say(json.dumps({"card": card, "profile": recs}))


if __name__ == "__main__":
    main()
