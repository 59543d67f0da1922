#!/usr/bin/env python3
"""Where the device time of the port's two paths goes.

    python3 tools/torch_profile.py [--out DIR]

First the co-scheduler's training engine (``core/train.py``) at
``chip_smoke.py``'s phase 4 settings (16 envs, window 8): after warm-up
steps that fill the replay ring past one batch, 5 engine steps run under
``torch.profiler``, once with the perfmodel replayed from its CUDA graph
(the training path) and once launched kernel by kernel.  Then one step of
``chip_smoke.py``'s LM train tenant (llama3-8b widths, 4 layers, 1 x 4096
tokens, block remat) after two warm-up steps, its kernels filed as flash
forward, attention backward, chunked CE, AdamW, cuBLAS and other (below),
and, off the path, the attention backward alone at one layer's shape
beside ``scaled_dot_product_attention``'s backward.  Then one step of
``chip_smoke.py`` (d)'s xLSTM train tenant (xlstm-125m, 32 x 1024 tokens),
its kernels filed as mLSTM chunks, sLSTM loop, chunked CE, AdamW, cuBLAS
and other (some 5 x 10^5 kernels: its trace takes minutes to read).  Then
the vectorized simulator's 64-trace sweeps of ``chip_smoke.py`` phase 7,
time sharing and RL, with the engine's iterations and kernels an
iteration.  Then one step of each of phase 8's serving runs (the
qwen2-moe decode job, jamba's prefill and decode, chameleon's decode), its
kernels filed as MoE and Mamba scan (regions the package marks), flash,
decode attention, cuBLAS and other.  Then the pair of ``chip_smoke.py``
(prefill 1 x 8192 tokens,
decode batch 4 against a 32768-slot cache, full width, bf16): one prefill
step alone, one decode step alone, and one co-run macro-step of
``FusedCoRunner`` (both tenants on their streams).  ``--only`` picks parts
(``train``, ``lm``, ``xlstm``, ``vecsim``, ``serve``, ``pair``).  For each run it
prints the wall time, the device's busy time (the union of all kernel
intervals, over all streams), the idle share, the kernels the device ran,
the host's launch calls (kernels, graphs, copies), and the device time by
kernel class (the union of the class's kernel intervals).  Chrome traces go to ``DIR``
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
# the LM train step's classes: code regions the package marks with
# ``torch.profiler.record_function`` (the CE's forward ops also mark their
# backward nodes, by autograd sequence number), then kernel names
REGIONS = {"flash_attention_bwd": "attention backward", "chunked_ce": "chunked CE",
           "adamw": "AdamW", "mlstm_chunks": "mLSTM chunks", "slstm_loop": "sLSTM loop",
           "moe": "MoE", "mamba_scan": "Mamba scan"}
CLASSES = (("flash_attention", ("flash_fwd",)),
           ("decode_attention", ("decode_split", "decode_combine")),
           ("rmsnorm", ("rmsnorm_kernel", "rmsnorm_regs_kernel")),
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


def region_spans(events: list, fwd_tid) -> list[tuple]:
    """``(tid, start, end, class)`` of every marked region of :data:`REGIONS`,
    and of each backward node whose forward op ran inside a marked region on
    the forward thread ``fwd_tid`` (autograd runs those nodes on its own
    thread, outside the region; the trace links a node to its forward op by
    sequence number)."""
    spans = [(e["tid"], e["ts"], e["ts"] + e["dur"], REGIONS[e["name"]]) for e in events
             if e.get("cat") == "user_annotation" and e["name"] in REGIONS]
    fwd = [sp for sp in spans if sp[0] == fwd_tid]
    seq_class = {}
    for e in events:
        seq = e.get("args", {}).get("Sequence number")
        if e.get("cat") != "cpu_op" or seq is None or e["tid"] != fwd_tid:
            continue
        for _, a, b, cls in fwd:
            if a <= e["ts"] < b:
                seq_class[seq] = cls
    for e in events:
        seq = e.get("args", {}).get("Sequence number")
        if (e.get("cat") == "cpu_op" and e["name"].startswith("autograd::engine::evaluate_function")
                and seq in seq_class):
            spans.append((e["tid"], e["ts"], e["ts"] + e["dur"], seq_class[seq]))
    return spans


def train_step_classes(events: list, kernels: list, fwd_tid) -> list[str]:
    """The class of each kernel of an LM train step: flash forward by name;
    then attention backward, chunked CE or AdamW when the host call that
    launched it lies in one of :func:`region_spans`; then cuBLAS by name;
    else other."""
    hits = region_hits(events, kernels, fwd_tid)
    out = []
    for i, k in enumerate(kernels):
        by_name = kernel_class(k["name"])
        if by_name == "flash_attention":
            out.append("flash forward")
        else:
            out.append(hits.get(i) or ("cuBLAS" if by_name == "matmul (cuBLAS)" else "other"))
    return out


def serve_step_classes(events: list, kernels: list, fwd_tid) -> list[str]:
    """The class of each kernel of a serving step: its marked region (MoE,
    Mamba scan) when the host call that launched it lies in one, else
    :func:`kernel_class` of its name."""
    hits = region_hits(events, kernels, fwd_tid)
    return [hits.get(i) or kernel_class(k["name"]) for i, k in enumerate(kernels)]


def region_hits(events: list, kernels: list, fwd_tid) -> dict:
    """Index of each kernel launched inside one of :func:`region_spans`,
    to that region's class."""
    launches = {e["args"]["correlation"]: (e["tid"], e["ts"]) for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    # the classes of the spans around each launch, by one sweep over the
    # spans' ends and the launch times of each thread (an xLSTM step has
    # some 10^5 backward-node spans and 5 x 10^5 launches); a span holds
    # the launches at its start and at its end
    points: dict = {}
    for tid, a, b, cls in region_spans(events, fwd_tid):
        points.setdefault(tid, []).extend(((a, 0, cls), (b, 2, cls)))
    hits: dict = {}
    for i, k in enumerate(kernels):
        tid, ts = launches.get(k.get("args", {}).get("correlation"), (None, None))
        if tid in points:
            points[tid].append((ts, 1, i))
    for pts in points.values():
        open_spans = dict.fromkeys(REGIONS.values(), 0)
        for _, kind, what in sorted(pts, key=lambda p: (p[0], p[1])):
            if kind == 1:
                hits[what] = next((c for c, n in open_spans.items() if n), None)
            else:
                open_spans[what] += 1 if kind == 0 else -1
    return hits


def profile(torch, label: str, fn, out_dir: Path, keep: bool = True, classes=None) -> dict:
    """Run ``fn`` under the profiler; its trace stays in ``out_dir`` when
    ``keep`` (a training trace holds some 10^5 kernels and is not kept).
    ``classes(events, kernels)`` names each kernel's class (by default
    :func:`kernel_class` of its name)."""
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
    # a class's time is the union of its kernels' intervals: decode's combine
    # pass starts early and waits for the split kernel, and is not counted twice
    names = (classes(events, kernels) if classes is not None
             else [kernel_class(e["name"]) for e in kernels])
    intervals: dict[str, list] = {}
    for e, cls in zip(kernels, names):
        intervals.setdefault(cls, []).append((e["ts"], e["ts"] + e["dur"]))
    by_class = {c: busy_us(iv) for c, iv in intervals.items()}
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


def lm_train_step(torch, out_dir: Path) -> dict:
    """One step of phase 5's train tenant under the profiler, after two
    warm-up steps."""
    import threading

    from repro_torch.optim import tree_leaves

    tenant = chip_smoke.train_tenant()
    state = tenant.state
    for _ in range(2):
        state = tenant.step_fn(state)
    holder = [state]

    def one():
        holder[0] = tenant.step_fn(holder[0])

    tid = threading.get_native_id()
    rec = profile(torch, "lm_train_step", one, out_dir, keep=False,
                  classes=lambda events, kernels: train_step_classes(events, kernels, tid))
    cfg, _ = chip_smoke.lm_train_config()
    rec["attention_backward_ms_per_layer"] = (
        rec["device_ms_by_class"].get("attention backward", 0.0) / cfg.n_layers)
    # AdamW's least work: each bf16 gradient read, the f32 master, m and v
    # read and written, the bf16 parameter written (28 bytes), and about 12
    # f32 operations, a parameter
    n = sum(p.numel() for p in tree_leaves(holder[0][0]))
    rec["adamw_params"] = n
    rec["adamw_bound_ms"], rec["adamw_bound_by"] = chip_smoke.bound(28.0 * n, 12.0 * n,
                                                                    "float32")
    chip_smoke.say(f"[profile] lm_train_step: attention backward "
                   f"{rec['attention_backward_ms_per_layer']:.3f} ms per layer; AdamW "
                   f"{rec['device_ms_by_class'].get('AdamW', 0.0):.3f} ms, bound "
                   f"{rec['adamw_bound_ms']:.3f} ms ({rec['adamw_bound_by']}) over {n} "
                   f"parameters")
    return rec


def xlstm_train_step(torch, out_dir: Path) -> dict:
    """One step of ``chip_smoke.py`` (d)'s xLSTM train tenant (xlstm-125m at
    full width, 32 x 1024 tokens, block remat on each pair) under the
    profiler, after one warm-up step: its kernels filed as mLSTM chunks
    (the chunked recurrence: forward, recompute, backward), sLSTM loop
    (the per-token recurrence), chunked CE, AdamW, cuBLAS and other."""
    import threading

    tenant = chip_smoke.xlstm_tenant()
    holder = [tenant.step_fn(tenant.state)]

    def one():
        holder[0] = tenant.step_fn(holder[0])

    tid = threading.get_native_id()
    return profile(torch, "xlstm_train_step", one, out_dir, keep=False,
                   classes=lambda events, kernels: train_step_classes(events, kernels, tid))


def attention_backward_alone(torch) -> dict:
    """Off the path: ``flash_attention_bwd`` at one layer's shape of the
    train step (1 x 4096 tokens, 32/8 heads of 128, causal, bf16) beside
    ``scaled_dot_product_attention``'s backward (``enable_gqa=True``) on the
    same inputs, as device time over repeated calls, and the bound of the
    backward's five products (each input read once, each gradient written
    once)."""
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention_bwd

    cfg, shape = chip_smoke.lm_train_config()
    S, Hq, Hkv, D = shape.seq_len, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    gen = torch.Generator("cuda").manual_seed(41)
    q, dout = (torch.randn((1, S, Hq, D), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(2))
    k, v = (torch.randn((1, S, Hkv, D), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    with torch.no_grad():
        out = flash_attention(q, k, v, causal=True)
    ours = chip_smoke.time_ms(torch, lambda: flash_attention_bwd(q, k, v, out, dout, True, None),
                              3)
    qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
    o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)
    do = dout.transpose(1, 2)
    lib = chip_smoke.time_ms(
        torch, lambda: torch.autograd.grad(o, (qs, ks, vs), do, retain_graph=True), 10)
    pairs = float(np.arange(1, S + 1).sum())
    bound, by = chip_smoke.bound((4 * S * Hq * D + 4 * S * Hkv * D) * 2,
                                 10.0 * Hq * D * pairs, "bfloat16")
    rec = {"shape": f"1 x {S}, Hq {Hq}, Hkv {Hkv}, D {D}, causal, bf16",
           "flash_attention_bwd_ms": ours, "sdpa_backward_ms": lib, "bound_ms": bound,
           "bound_by": by}
    chip_smoke.say(f"[profile] attention backward alone: {json.dumps(rec)}")
    return rec


def vecsim_sweeps(torch, out_dir: Path) -> dict:
    """The vectorized simulator's sweeps at ``chip_smoke.py`` phase 7's
    settings (64 poisson traces of 80 arrivals, load 1.25, window 8,
    capacity 128): time sharing, then the RL engine with a seeded untrained
    agent of phase 4's shape (every formation runs the same episode and
    co-run model, whatever the weights), each after a warm-up sweep.  Adds
    the engine's iteration and formation counts and kernels an iteration."""
    from repro_torch.core import EnvConfig, make_zoo
    from repro_torch.core.agent import DQNAgent
    from repro_torch.core.env import CoScheduleEnv
    from repro_torch.online import (
        RLDispatchPolicy, TimeSharingPolicy, VectorizedClusterSimulator, poisson_trace,
    )

    zoo = make_zoo()
    traces = [poisson_trace(zoo, n=chip_smoke.ONLINE_ARRIVALS, load=chip_smoke.ONLINE_LOAD,
                            seed=s, capacity=1.0) for s in range(chip_smoke.SWEEP_TRACES)]
    env_cfg = EnvConfig(window=chip_smoke.TRAIN_WINDOW, c_max=4)
    env = CoScheduleEnv(env_cfg)
    recs = {}
    for label, policy in (
            ("vecsim_sweep_time_sharing", TimeSharingPolicy()),
            ("vecsim_sweep_rl", RLDispatchPolicy(DQNAgent(env.state_dim, env.n_actions, seed=0),
                                                 env_cfg))):
        eng = VectorizedClusterSimulator(policy, window=chip_smoke.TRAIN_WINDOW,
                                         capacity=chip_smoke.SWEEP_CAPACITY)
        eng.sweep(traces)
        rec = profile(torch, label, lambda: eng.sweep(traces), out_dir, keep=False)
        stats = dict(eng._runf.stats)
        rec.update(stats, kernels_per_iteration=rec["kernels"] / max(1, stats["iterations"]))
        chip_smoke.say(f"[profile] {label}: engine {json.dumps(stats)}, "
                       f"{rec['kernels_per_iteration']:.0f} kernels an iteration")
        recs[label] = rec
    return recs


def serve_steps(torch, out_dir: Path) -> dict:
    """One step of each of ``chip_smoke.py`` phase 8's serving runs, each
    after a warm-up, its kernels filed as MoE, Mamba scan, flash, decode
    attention, cuBLAS and other: the zoo's qwen2-moe-a2.7b decode job
    (batch 8 against 4096 slots), jamba-v0.1-52b's prefill (1 of 4
    super-blocks, 1 x 8192) and decode step (batch 8 against 32768 slots),
    and chameleon-34b's decode step (16 of 48 layers, batch 1 against 4112
    slots)."""
    import threading

    from repro_torch.configs import SHAPES, get_config, scaled_shape
    from repro_torch.models import model as tm

    tid = threading.get_native_id()
    recs = {}

    def run(label, fn):
        fn()                                                     # warm-up
        recs[label] = profile(torch, label, fn, out_dir, keep=False,
                              classes=lambda ev, ks: serve_step_classes(ev, ks, tid))

    arch, shape_name, bdiv, sdiv = chip_smoke.MOE_JOB
    stream = torch.cuda.current_stream()
    tenant = chip_smoke.make_decode(torch, get_config(arch), 1.0, stream,
                                    scaled_shape(SHAPES[shape_name], bdiv, sdiv))
    run("moe_decode_step", lambda: tenant.step_fn(tenant.state))
    del tenant
    chip_smoke.free(torch)

    full = get_config("jamba-v0.1-52b")
    cfg = full.replace(n_layers=chip_smoke.JAMBA_BLOCKS * full.attn_every)
    params = tm.init_params(cfg, seed=16)
    gen = torch.Generator("cuda").manual_seed(17)
    tokens = torch.randint(0, cfg.vocab_size, (1, 8192), generator=gen, device="cuda")
    run("jamba_prefill", lambda: tm.prefill(params, tokens, cfg, 8192))
    smax, B = SHAPES["decode_32k"].seq_len, chip_smoke.FAMILY_BATCH
    cache = tm.init_cache(params, cfg, B, smax)
    pos = torch.tensor(chip_smoke.ragged_starts(B, smax), dtype=torch.int32, device="cuda")
    run("jamba_decode_step", lambda: tm.decode_step(params, cache, tokens[0, :B], pos, cfg))
    del params, cache
    chip_smoke.free(torch)

    full = get_config("chameleon-34b")
    cfg = full.replace(n_layers=chip_smoke.CHAMELEON_LAYERS)
    params = tm.init_params(cfg, seed=18)
    cache = tm.init_cache(params, cfg, 1, 4096 + chip_smoke.FAMILY_STEPS)
    pos = torch.full((1,), 4096, dtype=torch.int32, device="cuda")
    run("chameleon_decode_step", lambda: tm.decode_step(params, cache, tokens[0, :1], pos, cfg))
    del params, cache
    chip_smoke.free(torch)
    return recs


SECTIONS = ("train", "lm", "xlstm", "vecsim", "serve", "pair")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "profile"))
    ap.add_argument("--only", nargs="+", choices=SECTIONS, default=list(SECTIONS),
                    help="profile these parts only (default: all)")
    args = ap.parse_args()
    import torch

    card = chip_smoke.phase_card(torch)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    from repro_torch.runtime.multitenant import FusedCoRunner

    recs = {}
    if "train" in args.only:
        for graphs in (True, False):
            label = f"train_{TRAIN_STEPS}_engine_steps_{'graphed' if graphs else 'eager'}"
            eng = train_engine(torch, graphs)
            recs[label] = profile(torch, label, lambda: [eng.step() for _ in range(TRAIN_STEPS)],
                                  out_dir, keep=False)
            del eng
    if "lm" in args.only:
        recs["lm_train_step"] = lm_train_step(torch, out_dir)
        recs["attention_backward_alone"] = attention_backward_alone(torch)
        torch.cuda.empty_cache()
    if "xlstm" in args.only:
        recs["xlstm_train_step"] = xlstm_train_step(torch, out_dir)
        torch.cuda.empty_cache()
    if "vecsim" in args.only:
        recs.update(vecsim_sweeps(torch, out_dir))
    if "serve" in args.only:
        recs.update(serve_steps(torch, out_dir))
    if "pair" not in args.only:
        chip_smoke.say(json.dumps({"card": card, "profile": recs}))
        return

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
