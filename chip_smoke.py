#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which stops the run with a non-zero exit on failure:

0. The card: CUDA and an sm_90 device are required.  Prints the card's name
   and power limit and builds the CUDA kernels from ``src/repro_torch/csrc``.
1. Each kernel against its plain PyTorch version on the card, at the shapes
   the main path gives it, in bfloat16 and float32, timed beside its bound
   and beside one PyTorch library call computing the same function (kernel
   and library call as device time, replayed from a CUDA graph; the plain
   version eagerly).  Flash attention also runs right-aligned (Sq 1000
   against Skv 8192) and at the edges of its bf16 kernel's 128-row tiles
   (Sq, Skv of 127, 129, 1000, causal and not, Sq > Skv with rows that see
   no key) and at phase 8's head groups (16/16 and 64/8 heads at 1 x
   8192).  Decode attention also runs with a row of length 0.  RMSNorm
   runs at the llama3-8b prefill tenant's residual stream (8192 x 4096, bf16
   and f32), at a ragged 1000 x 4100 (bf16) and 1000 x 4101 (f32), whose d
   leaves a scalar head and tail beside the 16-byte vectors, and at
   4095 x 1024 (bf16), whose last block holds one row short; no path of the
   package calls it, so its wrapper's own entry point is its path.
2. The RL co-scheduler: the trained agent of ``tests/golden`` schedules the
   paper queues on the card; its greedy actions must equal the same agent's
   on the CPU, and every schedule must satisfy the problem's constraints.
3. The co-scheduled pair: llama3-8b at its published widths runs a prefill
   tenant (1 x 8192 tokens) and a decode tenant (batch 4 against a
   32768-slot cache) through ``FusedCoRunner`` on two CUDA streams, with
   shares 0.75 / 0.25.  Both kernels must be launched by that run.  Each
   tenant then runs alone (time sharing) and must give the same outputs; a
   small model must give the same logits on the card as on the CPU.
4. Training the co-scheduler on the card, with ``examples/co_schedule.py``'s
   settings: the batched DQN engine (``train_agent``) for 1500 episodes over
   16 envs at window 8, then the 12 paper queues scheduled by the trained
   agent beside time sharing, MPS-only and the exhaustive oracle.  Every
   schedule must be valid, the agent must stay at or under the oracle on
   every queue and average above 1.1x time sharing, and its greedy actions on
   the card must equal the same parameters' on the CPU.
5. Training the LM tenants.  (a) One train step of a small f32 model
   (llama3-8b's smoke config at D=128, TF32 off) on the card against the
   CPU: the loss, every gradient leaf and the updated parameters, within the
   bounds stated at ``LM_LOSS_TOL``.  (b) The train tenant of
   ``examples/co_schedule.py`` step 4 at llama3-8b's published widths, cut
   to 4 of its 32 layers, on 1 x 4096 markov tokens with block remat: 24
   steps, each one's loss, grad norm, lr and synchronized time, and the
   peak memory; it fails unless every loss and grad norm is finite, the last
   loss is below the first and the flash kernel ran 2 x layers x steps
   times.  (c) That tenant (share 0.75, 24 steps) co-run with phase 3's
   decode tenant (share 0.25, 8 steps) on two streams, then each alone, as
   phase 3 reports its pair; the decode logits and the train losses of the
   co-run must equal the solo runs' within the stated bounds.  (d) Step 4
   of ``examples/co_schedule.py`` as written: that llama train tenant
   (share 0.75, 24 steps) beside an xlstm-125m train tenant at full width
   and depth (share 0.25, 8 steps, 32 x 1024 markov tokens, the zoo's
   ``train_4k`` shape for that job) on two streams, then each alone; it
   fails unless the co-run launched exactly 2 x 4 x 24 flash kernels and no
   other hand-written kernel, each tenant's co-run losses equal its solo
   losses, and the xLSTM losses are finite and fall.  One more xLSTM step
   runs under the profiler for its device launches and device time.  (e)
   One f32 train step of xlstm-125m's smoke config on the card against the
   CPU (the bounds of (a)), ``prefill`` and 16 ``decode_step``s card
   against CPU, then 8 timed decode steps of xlstm-125m at full width on
   the zoo's decode_32k job (batch 128).
6. The online cluster of ``examples/online_cluster.py`` at its defaults
   (poisson trace of 80 arrivals at load 1.25, window 8, one pod of 8, hash
   router, concurrent): time sharing, the greedy packer, phase 4's agent on
   the card and a CPU copy of it, then the agent with periodic re-training
   on the card and telemetry on.  It fails unless the card's RL run equals
   the CPU's key for key, RL reaches 0.99 x time sharing's throughput, the
   telemetry registry agrees with ``summary()`` and the retrainer fired
   and hot-swapped the agent.
7. The vectorized simulator (``repro_torch/online/vecsim.py``) on the card
   at phase 6's settings.  (a) Time sharing on phase 6's trace must equal
   phase 6's heap run (decisions exactly, times within f32); a sweep of 64
   poisson traces (seeds 0-63, capacity 128) must equal single-trace runs
   on 4 of its lanes; traces/s of the sweep and of the heap.  (b) Phase 4's
   agent: the engine's run must equal phase 6's heap RL run, its 64-trace
   sweep its single runs, and a population of 4 agents (phase 4's and three
   perturbed copies) in one ``sweep(param_sets=...)`` each agent's own
   sweep bit for bit.  (c) The (8, 8, 4, 4) fleet under the hash router,
   time sharing and RL, must equal the heap fleet.  (d) The rollout
   collector at eps 0.25 on 8 traces with the same draws on the card and
   on the CPU: actions, masks and valid flags equal, buckets within 1e-5;
   then phase 6's trace under ``OnlineRetrainer(reward="queueing")`` with
   ``default_retrain_online_config()``, warm-started from phase 4's agent,
   every 30 simulated minutes: it must fire and hot-swap.
8. Serving the moe, hybrid and vlm families.  (a) The smoke configs of
   deepseek-moe-16b, qwen2-moe-a2.7b, jamba-v0.1-52b and chameleon-34b at
   D=128, f32 with TF32 off, card against CPU: the loss, ``moe_aux`` and
   ``moe_z`` within 1e-5 relative and ``moe_drop_frac`` equal; ``prefill``
   and 8 ``decode_step``s, logits rows within 1e-4.  (b) The zoo's
   qwen2-moe-a2.7b decode job at its published width and depth (batch 8
   against a 4096-slot cache at ragged lengths, share 0.25, 8 steps) beside
   phase 3's llama3-8b prefill tenant (share 0.75, 12 steps) on two
   streams, then each alone: it fails unless the co-run launched 32 flash
   kernels a prefill step and 24 decode kernels a decode step and each
   tenant's co-run logits equal its solo logits; then one decode step's
   ms, device launches and idle share.  (c) ``repro_torch.launch.serve``
   at deepseek-moe-16b's full width and depth (batch 4, 32 steps): 28 x 32
   decode launches and finite logits.  (d) jamba-v0.1-52b at its published
   widths cut to 1 of its 4 super-blocks (the whole model, 103 GB in bf16,
   does not fit one card): ``make_prefill_step`` on 1 x 8192 tokens (one
   flash launch, the MoE drop fraction), then 16 ``make_decode_step``
   steps at batch 8 against a 32768-slot cache at ragged lengths with zero
   Mamba state.  (e) chameleon-34b at its published widths cut to 16 of 48
   layers: prefill 1 x 4096, the cache grown by 16 slots, 16 decode steps;
   then the QK-norm cache: a prefill of 4095 tokens and a decode of token
   4095 must give the last logits of the prefill of all 4096 within 1e-4
   in f32 (the bf16 figure is printed beside the same weights' without
   the QK-norm: two orders of bf16 rounding).

The line before the last is the ``{"kernels": [...]}`` record; the last
line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

GOLDEN = ROOT / "tests" / "golden" / "train_agent_proxy_v1.npz"
# H100 SXM data sheet, dense: HBM3 rate; bf16 tensor-core and f32 CUDA-core peaks
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
# Each output row (one query head of one token, or one token's logits) is
# held against the plain version's by its relative L2 error
# ||out - ref|| / ||ref||, which scales with the row: a bf16 row that attends
# over thousands of keys has entries near 1e-2, where an absolute bound of
# the same order passes a row that lost part of its keys.  Rounding the
# output to bf16 alone costs about 2e-3.  A row whose reference is 0 (no
# visible key) must be exactly 0.
ROW_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
PREFILL_STEPS, DECODE_STEPS = 12, 8
SHARES = {"prefill": 0.75, "decode": 0.25}      # examples/co_schedule.py


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 0: the card
# ---------------------------------------------------------------------------

def phase_card(torch):
    if not torch.cuda.is_available():
        fail("no CUDA device")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        fail(f"the kernels need an sm_90 card, found sm_{cap[0]}{cap[1]}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    say(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    reports = build.build_all()
    say(f"[0] built {sorted(reports) or 'nothing (cached)'} in {time.perf_counter() - t0:.1f} s")
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"    {name}: {line.strip()}")
    return card


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------

def time_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_graph_ms(torch, fn, reps: int) -> float:
    """Device time of one call: ``reps`` calls captured in one CUDA graph and
    replayed, so that the host's side of a launch (the Python wrapper, some
    15-30 us) is not in the time of a kernel shorter than it."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (3 * reps)


def row_rel_err(torch, out, ref) -> float:
    """The largest ||out - ref|| / ||ref|| over the last axis's rows."""
    diff = (out.float() - ref.float()).flatten(0, -2).norm(dim=-1)
    size = ref.float().flatten(0, -2).norm(dim=-1)
    return torch.where(diff == 0, torch.zeros_like(diff), diff / size).max().item()


def compare(torch, out, ref, dtype_name: str, what: str) -> dict:
    if out.shape != ref.shape or not torch.isfinite(out.float()).all():
        fail(f"{what}: shape {tuple(out.shape)} vs {tuple(ref.shape)} or non-finite output")
    rel = row_rel_err(torch, out, ref)
    err = (out.float() - ref.float()).abs().max().item()
    if not rel <= ROW_TOL[dtype_name]:
        fail(f"{what}: row relative error {rel:.3e} above tolerance {ROW_TOL[dtype_name]:g} "
             f"(max abs error {err:.3e})")
    return {"max_abs_err": err, "row_rel_err": rel}


def show(rec: dict) -> str:
    return " ".join(f"{'kernel_ms' if k == 'ms' else k}={v}" for k, v in rec.items())


def bound(byts: float, ops: float, dtype_name: str) -> tuple[float, str]:
    t_bytes, t_ops = byts / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def decode_case(torch, dtype, lengths, smax=32768, hq=32, hkv=8, d=128, timed=True):
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_plain

    name = str(dtype).split(".")[1]
    gen = torch.Generator("cuda").manual_seed(11)
    B = len(lengths)
    q = torch.randn((B, hq, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, smax, hkv, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, smax, hkv, d), generator=gen, device="cuda").to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    for b, n in enumerate(lengths):
        k[b, n:] = 3e4     # large values past each length: never read
        v[b, n:] = -3e4
    out = decode_attention(q, k, v, lens)
    ref = decode_attention_plain(q, k, v, lens)
    rec = compare(torch, out, ref, name, f"decode_attention {name} lengths={lengths}")
    if timed:
        esize = q.element_size()
        rows = sum(lengths)
        rec["bound_ms"], rec["bound_by"] = bound(
            2 * B * hq * d * esize + 2 * rows * hkv * d * esize + 4 * B, 4.0 * rows * hq * d, name)
        rec["ms"] = time_graph_ms(torch, lambda: decode_attention(q, k, v, lens), 20)
        rec["plain_ms"] = time_ms(torch, lambda: decode_attention_plain(q, k, v, lens), 3)
        mask = (torch.arange(smax, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
        qs, ks, vs = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
        rec["library_ms"] = time_graph_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=True), 10)
    say(f"[1] decode_attention {name} B={B} Smax={smax} Hq={hq} Hkv={hkv} D={d} "
        f"lengths={lengths}: {show(rec)} row_tol={ROW_TOL[name]:g}")
    return rec


def flash_case(torch, dtype, sq=8192, skv=8192, hq=32, hkv=8, d=128, batch=1, causal=True,
               timed=True):
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    name = str(dtype).split(".")[1]
    gen = torch.Generator("cuda").manual_seed(12)
    q = torch.randn((batch, sq, hq, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((batch, skv, hkv, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((batch, skv, hkv, d), generator=gen, device="cuda").to(dtype)
    out = flash_attention(q, k, v, causal=causal)
    ref = flash_attention_plain(q, k, v, causal=causal)
    what = f"flash_attention {name} B={batch} Sq={sq} Skv={skv} Hq={hq} Hkv={hkv} causal={causal}"
    rec = compare(torch, out, ref, name, what)
    if timed:
        esize = q.element_size()
        pairs = float(np.clip(np.arange(sq) + (skv - sq) + 1, 0, skv).sum())   # visible (q, k)
        rec["bound_ms"], rec["bound_by"] = bound(
            (2 * sq * hq * d + 2 * skv * hkv * d) * esize, 4.0 * hq * d * pairs, name)
        rec["ms"] = time_graph_ms(torch, lambda: flash_attention(q, k, v, causal=True),
                                  10 if name == "bfloat16" else 2)
        rec["plain_ms"] = time_ms(torch, lambda: flash_attention_plain(q, k, v, causal=True), 1)
        qs, ks, vs = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        rec["library_ms"] = time_graph_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True, enable_gqa=True), 10)
    say(f"[1] {what} D={d}: {show(rec)} row_tol={ROW_TOL[name]:g}")
    return rec


def rmsnorm_case(torch, dtype, rows=8192, d=4096, timed=True):
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain

    name = str(dtype).split(".")[1]
    gen = torch.Generator("cuda").manual_seed(13)
    x = torch.randn((rows, d), generator=gen, device="cuda").to(dtype)
    scale = torch.randn((d,), generator=gen, device="cuda").to(dtype)
    out = rmsnorm(x, scale, eps=1e-5)
    ref = rmsnorm_plain(x, scale, eps=1e-5)
    rec = compare(torch, out, ref, name, f"rmsnorm {name} {rows}x{d}")
    if timed:
        esize = x.element_size()
        # f32 arithmetic on the CUDA cores (square-add, two multiplies a value)
        rec["bound_ms"], rec["bound_by"] = bound((2 * rows * d + d) * esize, 4.0 * rows * d,
                                                 "float32")
        rec["ms"] = time_graph_ms(torch, lambda: rmsnorm(x, scale, eps=1e-5), 50)
        rec["plain_ms"] = time_ms(torch, lambda: rmsnorm_plain(x, scale, eps=1e-5), 10)
        rec["library_ms"] = time_graph_ms(
            torch, lambda: F.rms_norm(x, (d,), weight=scale, eps=1e-5), 50)
    say(f"[1] rmsnorm {name} rows={rows} d={d} eps=1e-5: {show(rec)} row_tol={ROW_TOL[name]:g}")
    return rec


def phase_kernels(torch, card):
    say(f"[1] kernels against their plain versions on {card}")
    lengths = [32760, 20001, 1, 12345]    # ragged: not tile multiples, and a length of 1
    recs = {"decode_attention": decode_case(torch, torch.bfloat16, lengths),
            "flash_attention": flash_case(torch, torch.bfloat16)}
    decode_case(torch, torch.float32, lengths)
    decode_case(torch, torch.bfloat16, [0, 5, 4097], smax=4160, timed=False)   # length 0 -> 0
    flash_case(torch, torch.float32)
    for dtype in (torch.bfloat16, torch.float32):                    # right-aligned, Sq < Skv
        flash_case(torch, dtype, sq=1000, skv=8192, timed=False)
    # the bf16 kernel's 128 x 128 tiles cut one row short, one row over, and
    # with Sq > Skv (causal rows with no visible key must give exactly 0)
    for sq, skv in ((127, 1000), (1000, 127), (129, 129)):
        for causal in (True, False):
            flash_case(torch, torch.bfloat16, sq=sq, skv=skv, hq=8, hkv=2, batch=2,
                       causal=causal, timed=False)
    # phase 8's head groups: 1 (qwen2-moe, deepseek-moe: 16/16) and 8
    # (chameleon: 64/8), at the prefill shape
    for hq, hkv in ((16, 16), (64, 8)):
        flash_case(torch, torch.bfloat16, hq=hq, hkv=hkv, timed=False)
    # phase 5's train tenant: its forward and remat recompute run the bf16 kernel
    cfg, shape = lm_train_config()
    flash_case(torch, torch.bfloat16, sq=shape.seq_len, skv=shape.seq_len, hq=cfg.n_heads,
               hkv=cfg.n_kv_heads, d=cfg.d_head, batch=shape.global_batch, timed=False)
    from repro_torch.kernels.rmsnorm import rmsnorm

    rmsnorm.launches = 0
    recs["rmsnorm"] = rmsnorm_case(torch, torch.bfloat16)
    rmsnorm_case(torch, torch.float32)
    # ragged rows and d: bf16 rows alternate between no head and a 4-element
    # tail and a 4-element head and no tail; f32 rows take each head and tail
    # length from 0 to 3, where a lost tail moves a row by ~4e-4 (the bf16
    # bound cannot see that; the f32 bound can)
    rmsnorm_case(torch, torch.bfloat16, rows=1000, d=4100)
    rmsnorm_case(torch, torch.float32, rows=1000, d=4101)
    # two rows a block: the last block holds one row
    rmsnorm_case(torch, torch.bfloat16, rows=4095, d=1024, timed=False)
    if rmsnorm.launches == 0:
        fail("the rmsnorm wrapper launched no kernel")
    torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------------------------------
# phase 2: the RL co-scheduler
# ---------------------------------------------------------------------------

class ActionLog:
    """Records every action the wrapped agent takes."""

    def __init__(self, agent):
        self.agent, self.actions = agent, []

    def act(self, state, mask, greedy=True):
        a = self.agent.act(state, mask, greedy)
        self.actions.append(a)
        return a


def phase_schedule(card):
    from repro_torch.convert import GOLDEN_WINDOW, load_golden_dqn
    from repro_torch.core import EnvConfig, RLScheduler, make_zoo, paper_queues, validate_schedule

    zoo = make_zoo(dryrun_dir=None)
    env_cfg = EnvConfig(window=GOLDEN_WINDOW)
    queues = paper_queues(zoo, window=GOLDEN_WINDOW)
    logs = {}
    for device in ("cuda", "cpu"):
        log = ActionLog(load_golden_dqn(GOLDEN, device))
        sched = RLScheduler(log, env_cfg)
        out = {}
        for qname, queue in queues.items():
            s = sched.schedule(queue)
            validate_schedule(queue, s, env_cfg.c_max)
            out[qname] = s
        logs[device] = (log.actions, out)
    if logs["cuda"][0] != logs["cpu"][0]:
        fail("greedy actions on the card differ from the CPU's")
    say(f"[2] {len(zoo)} zoo jobs, {len(queues)} paper queues, {len(logs['cuda'][0])} greedy "
        f"actions on {card}: card == CPU")
    for qname, s in logs["cuda"][1].items():
        groups = " | ".join("+".join(j.name for j in g) + f" @ {p.label}"
                            for g, p in zip(s.groups, s.partitions))
        say(f"    {qname}: {groups}")


# ---------------------------------------------------------------------------
# phase 3: the co-scheduled pair
# ---------------------------------------------------------------------------

def ragged_starts(batch: int, smax: int, steps: int = DECODE_STEPS) -> list[int]:
    """Decode start positions at ragged lengths: phase 3's for batch 4
    against 32768 slots, else the first row ``steps`` short of ``smax`` and
    the others spread evenly below it, plus 3 (off the tiles' edges)."""
    if (batch, smax, steps) == (4, 32768, DECODE_STEPS):
        return [smax - DECODE_STEPS, 24577, 16001, 8191]
    top = smax - steps
    return [top] + [top * (batch - i) // batch + 3 for i in range(1, batch)]


def make_decode(torch, cfg, share, stream, dec=None):
    """Phase 3's decode tenant of ``cfg`` on ``stream``: batch 4 against a
    32768-slot cache (or the ``ShapeConfig`` ``dec``) filled at ragged
    lengths, weights and cache from seeded ``torch.Generator``s.  The step
    writes into the cache in place, and the same initial state gives the
    same steps again (each step reads only the rows before its own write),
    so ``dataclasses.replace`` of the tenant before it runs makes another
    that starts alike."""
    from repro_torch.configs import SHAPES, scaled_shape
    from repro_torch.models.model import decode_step, init_cache, init_params
    from repro_torch.runtime.multitenant import Tenant

    if dec is None:
        dec = scaled_shape(SHAPES["decode_32k"], 32, 1)    # batch 4, 32768-slot cache
    with torch.cuda.stream(stream):
        d_params = init_params(cfg, seed=2)
        cache = init_cache(d_params, cfg, dec.global_batch, dec.seq_len)
        gen = torch.Generator("cuda").manual_seed(22)
        for i in range(cfg.n_layers):
            cache["k"][i].normal_(generator=gen)
            cache["v"][i].normal_(generator=gen)
        start = ragged_starts(dec.global_batch, dec.seq_len)
        if max(start) + DECODE_STEPS > dec.seq_len:
            fail("decode would write past its cache")
        state0 = (torch.randint(0, cfg.vocab_size, (dec.global_batch,), generator=gen,
                                device="cuda"),
                  torch.tensor(start, dtype=torch.int32, device="cuda"), None)

    def decode_fn(state):
        tok, pos, _ = state
        logits, _ = decode_step(d_params, cache, tok, pos, cfg)
        return logits.argmax(dim=-1), pos + 1, logits

    return Tenant(f"{cfg.name}:{dec.name}", decode_fn, state0, share, stream=stream)


def make_prefill(torch, stream):
    """Phase 3's llama3-8b prefill tenant's pieces, made on ``stream``: its
    config, shape (1 x 8192 tokens) and step (state -> last logits)."""
    from repro_torch.configs import SHAPES, get_config, scaled_shape
    from repro_torch.models.model import init_params, prefill

    cfg = get_config("llama3-8b")
    pre = scaled_shape(SHAPES["prefill_32k"], 32, 4)       # batch 1 x 8192 tokens
    with torch.cuda.stream(stream):
        p_params = init_params(cfg, seed=1)
        gen = torch.Generator("cuda").manual_seed(21)
        tokens = torch.randint(0, cfg.vocab_size, (pre.global_batch, pre.seq_len),
                               generator=gen, device="cuda")

    def prefill_fn(state):
        logits, _ = prefill(p_params, tokens, cfg, pre.seq_len)
        return logits

    return cfg, pre, prefill_fn


def make_pair(torch):
    """Set up the co-scheduled llama3-8b pair on the card, one CUDA stream
    per tenant, and warm both up.  Returns ``(steps, tenants)``: the steps
    each tenant runs, and ``tenants(which)``, which makes fresh tenants
    (``which`` names "prefill", "decode" or both) that start from the same
    initial state every time."""
    from repro_torch.runtime.multitenant import Tenant

    s_pre, s_dec = torch.cuda.Stream(), torch.cuda.Stream()
    t0 = time.perf_counter()
    cfg, pre, prefill_fn = make_prefill(torch, s_pre)
    dec = make_decode(torch, cfg, SHARES["decode"], s_dec)
    tok, pos, _ = dec.state
    say(f"[3] {cfg.name}: d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.d_head}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.n_layers} of "
        f"{cfg.n_layers} layers (no depth cut), {cfg.dtype}; prefill {pre.global_batch}x"
        f"{pre.seq_len}, decode {dec.name} (batch {tok.shape[0]})")
    torch.cuda.synchronize()
    say(f"[3] set-up {time.perf_counter() - t0:.1f} s (weights from seeded torch.Generators, "
        f"cache filled at ragged lengths {pos.tolist()})")

    pre_name = f"{cfg.name}:{pre.name}"
    steps = {pre_name: PREFILL_STEPS, dec.name: DECODE_STEPS}

    def tenants(which):
        out = []
        if "prefill" in which:
            out.append(Tenant(pre_name, prefill_fn, None, SHARES["prefill"], stream=s_pre))
        if "decode" in which:
            out.append(dataclasses.replace(dec))
        return out

    # warm-up: one step of each on its stream (cuBLAS handles, first kernel loads)
    with torch.cuda.stream(s_pre):
        prefill_fn(None)
    with torch.cuda.stream(s_dec):
        dec.step_fn(dec.state)
    torch.cuda.synchronize()
    return steps, tenants


def kernel_wrappers() -> dict:
    """The launch-counting wrapper of every kernel, by name."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm

    return {"decode_attention": decode_attention, "flash_attention": flash_attention,
            "rmsnorm": rmsnorm}


def reset_launches() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def phase_pair(torch, card):
    from repro_torch.runtime.multitenant import FusedCoRunner

    torch.cuda.reset_peak_memory_stats()
    steps, tenants = make_pair(torch)
    reset_launches()
    co = tenants(("prefill", "decode"))
    runner = FusedCoRunner(co, steps, quanta_per_cycle=4)
    finish = runner.run()
    launches = read_launches()
    say(f"[3] co-run on two streams, quanta {dict(zip(steps, runner.quanta))}, kernel launches "
        f"{launches}")
    for name in ("flash_attention", "decode_attention"):
        if launches[name] == 0:
            fail(f"the co-run launched no {name} kernel")

    solo = {}
    for which in ("prefill", "decode"):
        t = tenants((which,))
        solo[t[0].name] = (FusedCoRunner(t, {t[0].name: steps[t[0].name]}).run()[t[0].name],
                           t[0].state)
    makespan = max(finish.values())
    ts = sum(s for s, _ in solo.values())
    for t in co:
        say(f"[3] {t.name}: {t.steps_done} steps, co-run finish {finish[t.name]:.3f} s, solo "
            f"{solo[t.name][0]:.3f} s  ({card})")
    say(f"[3] co-run makespan {makespan:.3f} s / time sharing {ts:.3f} s = "
        f"{makespan / ts:.3f}  ({card})")
    say(f"[3] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")

    def logits_of(state):      # prefill's state is its logits, decode's (token, pos, logits)
        return state[2] if isinstance(state, tuple) else state

    for t in co:
        got, ref = logits_of(t.state), logits_of(solo[t.name][1])
        if got.shape != ref.shape or not torch.isfinite(got).all():
            fail(f"{t.name}: logits of shape {tuple(got.shape)} or non-finite")
        rel = row_rel_err(torch, got, ref)
        if not rel <= ROW_TOL["bfloat16"]:
            fail(f"{t.name}: co-run logits differ from the solo run's by {rel:.3e} (row relative)")
        say(f"[3] {t.name}: logits {tuple(got.shape)} finite; co-run vs solo max abs diff "
            f"{(got - ref).abs().max().item():.3e}, row relative {rel:.3e}")
    return launches


def phase_reference(torch):
    """A small model gives the same logits through the kernels on the card as
    through the plain versions on the CPU."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as tm

    cfg = get_smoke_config("llama3-8b").replace(d_head=128, dtype="float32")   # the kernels' D
    cpu = tm.init_params(cfg, seed=3, device="cpu")

    def to(tree):
        return {k: to(v) if isinstance(v, dict) else v.cuda() for k, v in tree.items()}

    gpu = to(cpu)
    gen = torch.Generator().manual_seed(4)
    B, S = 2, 96
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    worst = 0.0
    lc, _ = tm.prefill(cpu, tokens, cfg, S)
    lg, _ = tm.prefill(gpu, tokens.cuda(), cfg, S)
    pairs = [(lg.cpu(), lc)]
    cc, cg = tm.init_cache(cpu, cfg, B, 8), tm.init_cache(gpu, cfg, B, 8)
    for t in range(8):
        pos = torch.full((B,), t, dtype=torch.int32)
        l1, _ = tm.decode_step(cpu, cc, tokens[:, t], pos, cfg)
        l2, _ = tm.decode_step(gpu, cg, tokens[:, t].cuda(), pos.cuda(), cfg)
        pairs.append((l2.cpu(), l1))
    for got, ref in pairs:
        err = (got - ref).abs()
        if (err > 2e-3 + 2e-2 * ref.abs()).any():
            fail(f"small model: card logits differ from the CPU's by {err.max().item():.3e}")
        worst = max(worst, err.max().item())
    say(f"[3] small model ({cfg.name}, D=128, f32): card == CPU within 2e-3 + 2e-2|x| "
        f"(max abs diff {worst:.2e})")


# ---------------------------------------------------------------------------
# phase 4: training the co-scheduler
# ---------------------------------------------------------------------------

TRAIN_EPISODES, TRAIN_WINDOW = 1500, 8        # examples/co_schedule.py's defaults


def train_config():
    """examples/co_schedule.py's training configuration."""
    from repro_torch.core.agent import DQNConfig
    from repro_torch.core.train import TrainConfig

    return TrainConfig(episodes=TRAIN_EPISODES, eval_every=TRAIN_EPISODES // 4, batch_envs=16,
                       dqn=DQNConfig(eps_decay_steps=TRAIN_EPISODES * 6))


def check_env_on_card(torch, zoo, env_cfg, n_envs=16):
    """The batched environment on the card (its perfmodel replayed from a
    CUDA graph) against the same on the CPU, on one stream of random valid
    actions: equal observations, masks and dones, rewards within 1e-5
    relative + 1e-4 (rewards are O(100) sums of f32 terms).  Also run by
    ``tests/test_torch_cuda.py``."""
    import numpy as np

    from repro_torch.core import make_queue
    from repro_torch.core.env import VecCoScheduleEnv
    from repro_torch.core.workloads import QUEUE_KINDS

    rng = np.random.default_rng(5)
    queues = [make_queue(zoo, QUEUE_KINDS[i % len(QUEUE_KINDS)], env_cfg.window, rng)
              for i in range(n_envs)]
    envs = {d: VecCoScheduleEnv(env_cfg, d) for d in ("cpu", "cuda")}
    live = {d: v.reset_batch(v.queue_batch(queues)) for d, v in envs.items()}
    worst, steps = 0.0, 0
    for _ in range(2 * env_cfg.window):
        m = live["cpu"][2].numpy()
        a = torch.from_numpy(np.array([rng.choice(np.flatnonzero(r)) if r.any() else 0
                                      for r in m]))
        out = {d: envs[d].step_batch(live[d][0], a.to(d)) for d in envs}
        (s_c, o_c, r_c, d_c, m_c), (s_g, o_g, r_g, d_g, m_g) = out["cpu"], out["cuda"]
        if not (torch.equal(o_g.cpu(), o_c) and torch.equal(m_g.cpu(), m_c)
                and torch.equal(d_g.cpu(), d_c)):
            fail("the environment on the card differs from the CPU's")
        err = (r_g.cpu() - r_c).abs()
        if (err > 1e-4 + 1e-5 * r_c.abs()).any():
            fail(f"environment rewards on the card differ from the CPU's by {err.max():.3e}")
        worst, steps = max(worst, err.max().item()), steps + 1
        live = {"cpu": (s_c, o_c, m_c), "cuda": (s_g, o_g, m_g)}
        if d_c.all():
            break
    if envs["cuda"]._metrics.replays == 0:
        fail("the environment on the card never replayed its perfmodel's CUDA graph")
    say(f"[4] environment: {n_envs} envs x {steps} steps on the card (perfmodel from a CUDA "
        f"graph, {envs['cuda']._metrics.replays} replays) == CPU; rewards within "
        f"{worst:.2e}")


def phase_train(torch, card):
    import numpy as np

    from repro_torch.core import (
        EnvConfig, RLScheduler, make_zoo, paper_queues, validate_schedule,
    )
    from repro_torch.core.agent import DQNAgent
    from repro_torch.core.baselines import POLICIES
    from repro_torch.core.metrics import summarize
    from repro_torch.core.train import train_agent

    zoo = make_zoo()
    env_cfg = EnvConfig(window=TRAIN_WINDOW, c_max=4)
    check_env_on_card(torch, zoo, env_cfg)
    cfg = train_config()
    say(f"[4] training the DQN co-scheduler on {card}: {len(zoo)} zoo jobs, window "
        f"{env_cfg.window}, {cfg.episodes} episodes over {cfg.batch_envs} envs")
    segments = []
    reset_launches()
    t0 = time.perf_counter()
    agent, hist = train_agent(zoo, env_cfg, cfg, device="cuda",
                              on_segment=lambda n, sec: segments.append((n, sec)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    for rec in hist:
        say(f"[4] {json.dumps(rec)}")
    steps = sum(n for n, _ in segments)
    seg_s = sum(sec for _, sec in segments)
    episodes = hist[-1]["episode"]
    say(f"[4] {episodes} episodes in {wall:.1f} s ({episodes / wall:.1f} episodes/s), "
        f"{steps} engine steps of {cfg.batch_envs} envs at {1e3 * seg_s / steps:.2f} ms each, "
        f"{agent.updates} updates; greedy evaluation {wall - seg_s:.1f} s  ({card})")
    for name, rec in (("eval_throughput", hist[-1]["eval_throughput"]),
                      ("heldout_throughput", hist[-1]["heldout_throughput"])):
        if rec is None or not np.isfinite(rec):
            fail(f"training: final {name} is {rec}")

    queues = paper_queues(zoo, window=TRAIN_WINDOW)
    cpu_agent = DQNAgent(agent.params["w0"].shape[0], agent.params["wA"].shape[1], cfg.dqn,
                         device="cpu", params={k: v.cpu() for k, v in agent.params.items()})
    actions = {}
    scheds = {}
    for device, a in (("cuda", agent), ("cpu", cpu_agent)):
        log = ActionLog(a)
        sched = RLScheduler(log, env_cfg)
        scheds[device] = {q: sched.schedule(queue) for q, queue in queues.items()}
        actions[device] = log.actions
    if actions["cuda"] != actions["cpu"]:
        fail("the trained agent's greedy actions on the card differ from the CPU's")
    say(f"[4] {len(actions['cuda'])} greedy actions over {len(queues)} paper queues: "
        f"card == CPU")
    say(f"[4] {'queue':6s} {'time_sharing':>12s} {'mps_only':>9s} {'rl':>7s} {'oracle':>7s}")
    rl = []
    for qname, queue in queues.items():
        s_rl = scheds["cuda"][qname]
        validate_schedule(queue, s_rl, env_cfg.c_max)
        row = [summarize(POLICIES["time_sharing"](queue, 4))["throughput"],
               summarize(POLICIES["mps_only"](queue, 4))["throughput"],
               summarize(s_rl)["throughput"],
               summarize(POLICIES["oracle"](queue, 4))["throughput"]]
        say(f"[4] {qname:6s} {row[0]:12.3f} {row[1]:9.3f} {row[2]:7.3f} {row[3]:7.3f}")
        if not row[2] <= row[3] + 1e-6:
            fail(f"{qname}: rl throughput {row[2]:.6f} above the oracle's {row[3]:.6f}")
        rl.append(row[2])
    mean_rl = float(np.mean(rl))
    say(f"[4] mean rl throughput {mean_rl:.3f} (time sharing = 1.0), every schedule valid, "
        f"rl <= oracle on every queue; kernel launches while training {launches}")
    if not mean_rl > 1.1:
        fail(f"the trained agent's mean throughput {mean_rl:.3f} is not above 1.1")
    return launches, agent


# ---------------------------------------------------------------------------
# phase 5: training the LM tenants
# ---------------------------------------------------------------------------

LM_LAYERS, LM_STEPS = 4, 24          # llama3-8b cut to 4 of its 32 layers; step 4's 24 steps
LM_SHARES = {"train": 0.75, "decode": 0.25}      # examples/co_schedule.py step 4
LM_SEED = 31
# (a) card against CPU, f32, TF32 off: the loss within 1e-5 relative; each
# gradient leaf within 1e-4 of its norm (||g_card - g_cpu|| / ||g_cpu||);
# the updated parameters within 2e-5 absolute, a tenth of the first step's
# learning rate (an AdamW step moves each entry by about lr, whatever its
# gradient's size, so an entry whose tiny gradient differs moves by at most
# that much).
LM_LOSS_TOL, LM_GRAD_TOL, LM_PARAM_TOL = 1e-5, 1e-4, 2e-5
# (c) co-run against solo: each step's loss within 1e-3 relative.  The two
# runs are the same computation; the bound leaves room for sums whose order
# is not fixed (atomics), which would move the losses of later steps.
LM_CORUN_LOSS_TOL = 1e-3


def lm_train_config():
    """Phase 5's train tenant: llama3-8b at its published widths, cut to
    ``LM_LAYERS`` layers, and its shape (1 x 4096 tokens)."""
    from repro_torch.configs import SHAPES, get_config, scaled_shape

    cfg = get_config("llama3-8b").replace(n_layers=LM_LAYERS)
    return cfg, scaled_shape(SHAPES["train_4k"], 256, 1)           # 1 x 4096 tokens


def train_tenant(stream=None):
    """Phase 5's train tenant, made from ``LM_SEED`` (on ``stream`` if given)."""
    from repro_torch.runtime.lm_train import make_train_tenant

    cfg, shape = lm_train_config()
    return make_train_tenant(f"{cfg.name}-{LM_LAYERS}L:{shape.name}", cfg, LM_SHARES["train"],
                             shape.seq_len, shape.global_batch, seed=LM_SEED, stream=stream)


def train_step_card_vs_cpu(torch, cfg, seq: int, seed: int) -> tuple[float, float, float]:
    """One f32 train step of ``cfg`` (2 x ``seq`` markov tokens, 30 labels
    masked) on the card and on the CPU from the same weights: returns the
    loss's relative difference, the worst gradient leaf's difference over
    its norm and the updated parameters' largest absolute difference."""
    from repro_torch.data import DataPipeline, batch_to_device
    from repro_torch.models.model import init_params, loss_fn
    from repro_torch.optim import (
        OptConfig, adamw_update, init_opt_state, tree_leaves, tree_unflatten,
    )

    opt_cfg = OptConfig(lr=1e-3, warmup_steps=5, decay_steps=1000)
    batch = DataPipeline(cfg.vocab_size, seq, 2, seed=7).batch(0)
    batch["labels"][0, 500:530] = -1                                 # masked labels
    out = {}
    for device in ("cpu", "cuda"):
        params = init_params(cfg, seed=seed, device="cpu")
        leaves = [p.to(device).requires_grad_(True) for p in tree_leaves(params)]
        params = tree_unflatten(params, leaves)
        total, _ = loss_fn(params, batch_to_device(batch, device), cfg)
        grads = torch.autograd.grad(total, leaves)
        params, _, _ = adamw_update(params, tree_unflatten(params, grads),
                                    init_opt_state(params), opt_cfg)
        out[device] = (total.item(), [g.cpu() for g in grads],
                       [p.detach().cpu() for p in tree_leaves(params)])
    (l_cpu, g_cpu, p_cpu), (l_gpu, g_gpu, p_gpu) = out["cpu"], out["cuda"]
    loss_err = abs(l_gpu - l_cpu) / abs(l_cpu)
    grad_err = max(((a - b).norm() / b.norm()).item() for a, b in zip(g_gpu, g_cpu))
    param_err = max((a - b).abs().max().item() for a, b in zip(p_gpu, p_cpu))
    say(f"    card vs CPU loss {l_gpu:.6f} vs {l_cpu:.6f} (relative {loss_err:.2e}, bound "
        f"{LM_LOSS_TOL:g}); worst gradient leaf {grad_err:.2e} of its norm (bound "
        f"{LM_GRAD_TOL:g}); updated parameters max abs diff {param_err:.2e} (bound "
        f"{LM_PARAM_TOL:g})")
    if not (loss_err <= LM_LOSS_TOL and grad_err <= LM_GRAD_TOL and param_err <= LM_PARAM_TOL):
        fail(f"{cfg.name}: a train step on the card differs from the CPU's")
    return loss_err, grad_err, param_err


def phase_lm_reference(torch):
    """(a) One train step of a small f32 model on the card against the CPU:
    the loss, every gradient leaf and the updated parameters."""
    from repro_torch.configs import get_smoke_config

    cfg = get_smoke_config("llama3-8b").replace(d_head=128, dtype="float32")   # the kernels' D
    say(f"[5] (a) small model ({cfg.name}, D=128, f32, TF32 off, 2 x 640 tokens):")
    train_step_card_vs_cpu(torch, cfg, 640, seed=6)


def lm_losses(state) -> list[float]:
    return [m["loss"].item() for m in state[2]]


def phase_lm_train(torch, card):
    """(b) The train tenant at llama3-8b's widths, 4 of 32 layers, alone."""
    import math

    from repro_torch.models.model import count_params_analytic

    cfg, shape = lm_train_config()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tenant = train_tenant()
    torch.cuda.synchronize()
    say(f"[5] (b) {cfg.name}: d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.d_head}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {LM_LAYERS} of 32 layers, "
        f"{cfg.dtype}, remat {cfg.remat}; {count_params_analytic(cfg) / 1e9:.3f} B params; "
        f"{shape.global_batch} x {shape.seq_len} markov tokens; set-up "
        f"{time.perf_counter() - t0:.1f} s")
    reset_launches()
    state, ms = tenant.state, []
    for _ in range(LM_STEPS):
        t1 = time.perf_counter()
        state = tenant.step_fn(state)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t1))
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, (m, t) in enumerate(zip(state[2], ms)):
        say(f"[5] (b) step {i + 1:2d}: loss {m['loss'].item():.4f} grad_norm "
            f"{m['grad_norm'].item():.4f} lr {m['lr'].item():.3e}  {t:.1f} ms")
    steady = sorted(ms[1:])[len(ms[1:]) // 2]
    say(f"[5] (b) {LM_STEPS} steps: first {ms[0]:.1f} ms, median of the rest {steady:.2f} ms "
        f"per step (synchronized, unprofiled), peak device memory {peak:.1f} GiB, flash "
        f"launches {launches['flash_attention']}  ({card})")
    losses = lm_losses(state)
    norms = [m["grad_norm"].item() for m in state[2]]
    if not all(math.isfinite(x) for x in losses + norms):
        fail("train tenant: a loss or grad norm is not finite")
    if not losses[-1] < losses[0]:
        fail(f"train tenant: the loss did not fall ({losses[0]:.4f} -> {losses[-1]:.4f})")
    if launches["flash_attention"] != 2 * LM_LAYERS * LM_STEPS:
        fail(f"train tenant: {launches['flash_attention']} flash launches, expected "
             f"{2 * LM_LAYERS * LM_STEPS} (forward and block-remat recompute of each layer)")


def run_group(torch, makers: dict, steps: dict, output):
    """Make a tenant of each role of ``makers`` (``maker(stream)``) from its
    seeds, each on a stream of its own, and run them through
    ``FusedCoRunner``.  Returns, by role, the tenant's name, its finish time
    and ``output(role, tenant)``, then the quanta, the kernel launches and
    the peak device memory in GiB."""
    from repro_torch.runtime.multitenant import FusedCoRunner

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    made = {r: maker(torch.cuda.Stream()) for r, maker in makers.items()}
    torch.cuda.synchronize()
    reset_launches()
    runner = FusedCoRunner(list(made.values()), {t.name: steps[r] for r, t in made.items()},
                           quanta_per_cycle=4)
    finish = runner.run()
    launches = read_launches()
    names = {r: t.name for r, t in made.items()}
    return (names, {r: finish[n] for r, n in names.items()},
            {r: output(r, t) for r, t in made.items()},
            dict(zip(names.values(), runner.quanta)), launches,
            torch.cuda.max_memory_allocated() / 2**30)


def phase_lm_pair(torch, card):
    """(c) The train tenant co-run with phase 3's decode tenant on two
    streams, then each alone; each run starts from the seeds."""
    from repro_torch.configs import get_config

    dec_cfg = get_config("llama3-8b")
    steps = {"train": LM_STEPS, "decode": DECODE_STEPS}
    # each step launches the flash kernel twice a layer (forward, remat
    # recompute) and decode attention once a layer
    expect = {"flash_attention": 2 * LM_LAYERS * LM_STEPS,
              "decode_attention": dec_cfg.n_layers * DECODE_STEPS, "rmsnorm": 0}

    makers = {"train": train_tenant,
              "decode": lambda stream: make_decode(torch, dec_cfg, LM_SHARES["decode"], stream)}

    def run(roles):
        # the train tenant's losses, the decode tenant's last logits
        return run_group(torch, {r: makers[r] for r in roles}, steps,
                         lambda r, t: lm_losses(t.state) if r == "train" else t.state[2])

    names, finish, co, quanta, launches, peak = run(("train", "decode"))
    say(f"[5] (c) co-run on two streams, quanta {quanta}, kernel launches {launches} (expected "
        f"{expect}), peak device memory {peak:.1f} GiB")
    if launches != expect:
        fail(f"the train pair's co-run launched {launches} kernels, expected {expect}")
    solo, solo_out = {}, {}
    for role in ("train", "decode"):
        _, fin, outputs, _, _, solo_peak = run((role,))
        solo[role], solo_out[role] = fin[role], outputs[role]
        say(f"[5] (c) {names[role]} alone: {solo[role]:.3f} s, peak device memory "
            f"{solo_peak:.1f} GiB")
    for role, name in names.items():
        say(f"[5] (c) {name}: co-run finish {finish[role]:.3f} s, solo {solo[role]:.3f} s  "
            f"({card})")
    makespan, ts = max(finish.values()), sum(solo.values())
    say(f"[5] (c) co-run makespan {makespan:.3f} s / time sharing {ts:.3f} s = "
        f"{makespan / ts:.3f}  ({card})")
    got, ref = co["decode"], solo_out["decode"]
    if got.shape != ref.shape or not torch.isfinite(got).all():
        fail(f"{names['decode']}: logits of shape {tuple(got.shape)} or non-finite")
    rel = row_rel_err(torch, got, ref)
    if not rel <= ROW_TOL["bfloat16"]:
        fail(f"{names['decode']}: co-run logits differ from the solo run's by {rel:.3e} "
             "(row relative)")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(co["train"], solo_out["train"]))
    say(f"[5] (c) {names['decode']}: co-run vs solo logits row relative {rel:.3e}; "
        f"{names['train']}: co-run vs solo losses of {LM_STEPS} steps within {loss_rel:.2e} "
        f"relative (bound {LM_CORUN_LOSS_TOL:g}); last loss {co['train'][-1]:.4f} co-run, "
        f"{solo_out['train'][-1]:.4f} solo")
    if len(co["train"]) != LM_STEPS or not loss_rel <= LM_CORUN_LOSS_TOL:
        fail(f"{names['train']}: co-run losses differ from the solo run's")
    return launches


# (d) step 4 of examples/co_schedule.py as written: the llama train tenant
# of (b) beside an xlstm-125m train tenant at full width, on the zoo's own
# shape for that job ("xlstm-125m", "train_4k", 8, 4): 32 x 1024 tokens
XLSTM_STEPS, XLSTM_SEED = 8, 33
STEP4_SHARES = {"train": 0.75, "xlstm": 0.25}


def xlstm_train_config():
    """(d)'s xLSTM tenant: xlstm-125m at its published widths and depth, on
    ``scaled_shape(train_4k, 8, 4)`` = 32 x 1024 tokens."""
    from repro_torch.configs import SHAPES, get_config, scaled_shape

    return get_config("xlstm-125m"), scaled_shape(SHAPES["train_4k"], 8, 4)


def xlstm_tenant(stream=None):
    from repro_torch.runtime.lm_train import make_train_tenant

    cfg, shape = xlstm_train_config()
    return make_train_tenant(f"{cfg.name}:{shape.name}", cfg, STEP4_SHARES["xlstm"],
                             shape.seq_len, shape.global_batch, seed=XLSTM_SEED, stream=stream)


def device_launches(torch, fn) -> tuple[int, float]:
    """Run ``fn`` once under ``torch.profiler`` (device activity only):
    the work items the device ran (kernels, copies, fills) and their busy
    time in ms (the union of their intervals).  Read from the profiler's raw
    events, which is quick where building its event tree is not."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA)
    busy, end = 0, float("-inf")
    for a, b in spans:
        busy += max(0, b - max(a, end))
        end = max(end, b)
    return len(spans), busy / 1e6


def phase_step4_pair(torch, card):
    """(d) The llama train tenant of (b) (share 0.75, 24 steps) co-run with
    the xlstm-125m train tenant (share 0.25, 8 steps) on two streams, then
    each alone; then one more xLSTM step under the profiler, for its
    launches and its device time."""
    from repro_torch.models.model import count_params_analytic

    cfg, shape = xlstm_train_config()
    steps = {"train": LM_STEPS, "xlstm": XLSTM_STEPS}
    # the xLSTM tenant launches no hand-written kernel
    expect = {"flash_attention": 2 * LM_LAYERS * LM_STEPS, "decode_attention": 0, "rmsnorm": 0}
    say(f"[5] (d) step 4 as written: {cfg.name}: d_model {cfg.d_model}, {cfg.n_heads} heads, "
        f"{cfg.n_layers} of {cfg.n_layers} layers ({cfg.n_layers // 2} mLSTM/sLSTM pairs, no "
        f"depth cut), mLSTM inner {int(cfg.xlstm.expand_m * cfg.d_model)} in chunks of "
        f"{cfg.xlstm.chunk}, vocab {cfg.vocab_size}, {cfg.dtype}, remat {cfg.remat}; "
        f"{count_params_analytic(cfg) / 1e6:.2f} M params; {shape.global_batch} x "
        f"{shape.seq_len} markov tokens")
    makers = {"train": train_tenant, "xlstm": xlstm_tenant}

    def run(roles):
        return run_group(torch, {r: makers[r] for r in roles}, steps,
                         lambda r, t: lm_losses(t.state))

    names, finish, co, quanta, launches, peak = run(("train", "xlstm"))
    say(f"[5] (d) co-run on two streams, quanta {quanta}, kernel launches {launches} (expected "
        f"{expect}), peak device memory {peak:.1f} GiB")
    if launches != expect:
        fail(f"step 4's co-run launched {launches} kernels, expected {expect}")
    solo, solo_out = {}, {}
    for role in ("train", "xlstm"):
        _, fin, outputs, _, _, solo_peak = run((role,))
        solo[role], solo_out[role] = fin[role], outputs[role]
        say(f"[5] (d) {names[role]} alone: {solo[role]:.3f} s, peak device memory "
            f"{solo_peak:.1f} GiB")
    for role, name in names.items():
        say(f"[5] (d) {name}: co-run finish {finish[role]:.3f} s, solo {solo[role]:.3f} s  "
            f"({card})")
    makespan, ts = max(finish.values()), sum(solo.values())
    say(f"[5] (d) co-run makespan {makespan:.3f} s / time sharing {ts:.3f} s = "
        f"{makespan / ts:.3f}  ({card})")
    for role, n in steps.items():
        rel = max(abs(a - b) / abs(b) for a, b in zip(co[role], solo_out[role]))
        say(f"[5] (d) {names[role]}: co-run vs solo losses of {n} steps within {rel:.2e} "
            f"relative (bound {LM_CORUN_LOSS_TOL:g}); loss {co[role][0]:.4f} -> "
            f"{co[role][-1]:.4f}")
        if len(co[role]) != n or not rel <= LM_CORUN_LOSS_TOL:
            fail(f"{names[role]}: co-run losses differ from the solo run's")
    losses = co["xlstm"]
    if not all(math.isfinite(x) for x in losses):
        fail(f"{names['xlstm']}: a loss is not finite")
    if not losses[-1] < losses[0]:
        fail(f"{names['xlstm']}: the loss did not fall ({losses[0]:.4f} -> {losses[-1]:.4f})")

    tenant = xlstm_tenant()
    state = tenant.step_fn(tenant.state)
    n, busy = device_launches(torch, lambda: tenant.step_fn(state))
    step_ms = 1e3 * solo["xlstm"] / XLSTM_STEPS
    say(f"[5] (d) {names['xlstm']}: {step_ms:.1f} ms a step (solo run, first step included), "
        f"{n} device launches a step and {busy:.1f} ms of device time (a second step, "
        f"profiled): idle share {1 - busy / step_ms:.3f} of the unprofiled step  ({card})")
    return launches


def phase_xlstm_reference(torch, card):
    """(e) xLSTM on the card against the CPU: one f32 train step of
    xlstm-125m's smoke config, then ``prefill`` and 16 ``decode_step``s of
    it; then 8 decode steps of xlstm-125m at full width on the zoo's
    decode_32k job (batch 128), timed."""
    from repro_torch.configs import SHAPES, get_config, get_smoke_config
    from repro_torch.models import model as tm
    from repro_torch.optim import tree_map

    cfg = get_smoke_config("xlstm-125m").replace(dtype="float32")
    say(f"[5] (e) {cfg.name} (f32, TF32 off, 2 x 600 tokens: the mLSTM pads its last chunk "
        f"of {cfg.xlstm.chunk}):")
    train_step_card_vs_cpu(torch, cfg, 600, seed=8)

    cpu = tm.init_params(cfg, seed=9, device="cpu")
    gpu = tree_map(lambda t: t.cuda(), cpu)
    gen = torch.Generator().manual_seed(10)
    B, S = 4, 40
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 16), generator=gen)
    lc, cc = tm.prefill(cpu, tokens[:, :S], cfg, S)
    lg, cg = tm.prefill(gpu, tokens[:, :S].cuda(), cfg, S)
    worst = row_rel_err(torch, lg.cpu(), lc)
    for t in range(16):
        pos = torch.full((B,), S + t, dtype=torch.int32)
        l1, cc = tm.decode_step(cpu, cc, tokens[:, S + t], pos, cfg)
        l2, cg = tm.decode_step(gpu, cg, tokens[:, S + t].cuda(), pos.cuda(), cfg)
        worst = max(worst, row_rel_err(torch, l2.cpu(), l1))
    say(f"[5] (e) prefill ({B} x {S}) and 16 decode steps: card == CPU, logits row relative "
        f"{worst:.2e} (bound {ROW_TOL['float32']:g})")
    if not worst <= ROW_TOL["float32"]:
        fail(f"{cfg.name}: decode logits on the card differ from the CPU's")

    cfg, dec = get_config("xlstm-125m"), SHAPES["decode_32k"]
    torch.cuda.empty_cache()
    params = tm.init_params(cfg, seed=11)
    cache = tm.init_cache(params, cfg, dec.global_batch, dec.seq_len)
    gen = torch.Generator("cuda").manual_seed(12)
    tok = torch.randint(0, cfg.vocab_size, (dec.global_batch,), generator=gen, device="cuda")
    pos = torch.zeros(dec.global_batch, dtype=torch.int32, device="cuda")
    ms = []
    for _ in range(1 + DECODE_STEPS):                       # one warm-up step
        t0 = time.perf_counter()
        logits, cache = tm.decode_step(params, cache, tok, pos, cfg)
        tok, pos = logits.argmax(dim=-1), pos + 1
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    if not torch.isfinite(logits).all():
        fail(f"{cfg.name}: decode logits are not finite")
    n, busy = device_launches(torch, lambda: tm.decode_step(params, cache, tok, pos, cfg))
    steady = sorted(ms[1:])[len(ms[1:]) // 2]
    say(f"[5] (e) {cfg.name} decode at {dec.name} (batch {dec.global_batch}, full width, "
        f"{cfg.n_layers} layers): {DECODE_STEPS} steps of median {steady:.2f} ms "
        f"(synchronized; {', '.join(f'{x:.1f}' for x in ms[1:])}), {n} device launches and "
        f"{busy:.2f} ms of device time a step  ({card})")


# phase 6: examples/online_cluster.py's defaults
ONLINE_ARRIVALS, ONLINE_LOAD, ONLINE_RETRAIN_S = 80, 1.25, 1800.0


def phase_online(torch, card, agent):
    """Phase 6: the online heap cluster of ``examples/online_cluster.py`` at
    its defaults (poisson trace, 80 arrivals, load 1.25, window 8, c_max 4,
    one pod of 8, hash router, concurrent mode), served by time sharing,
    the greedy packer and phase 4's trained agent (on the card, then a CPU
    copy of its parameters), then by the agent with periodic re-training
    on the card and telemetry on."""
    from repro_torch.core import EnvConfig, make_zoo
    from repro_torch.core.agent import DQNAgent
    from repro_torch.online import (
        ClusterSimulator, GreedyPackerPolicy, OnlineRetrainer, RLDispatchPolicy, SimConfig,
        Telemetry, TimeSharingPolicy, default_retrain_train_config, poisson_trace,
    )

    zoo = make_zoo()
    env_cfg = EnvConfig(window=TRAIN_WINDOW, c_max=4)
    trace = poisson_trace(zoo, n=ONLINE_ARRIVALS, load=ONLINE_LOAD, seed=0, capacity=1.0)
    say(f"[6] trace 'poisson': {len(trace)} arrivals over {trace[-1].t / 3600:.2f} simulated "
        f"hours (load {ONLINE_LOAD}, one pod of 8, 'hash' router, concurrent); RL is phase 4's "
        f"agent ({TRAIN_EPISODES} episodes; the example trains 800 of its own)")

    def cfg(tick=None):
        return SimConfig(window=TRAIN_WINDOW, mode="concurrent", pods=(8,), router="hash",
                         tick_interval_s=tick)

    cpu_agent = DQNAgent(agent.params["w0"].shape[0], agent.params["wA"].shape[1],
                         device="cpu", params={k: v.cpu() for k, v in agent.params.items()})
    results, secs = {}, {}
    for name, policy in (("time_sharing", TimeSharingPolicy()),
                         ("greedy_packer", GreedyPackerPolicy()),
                         ("rl", RLDispatchPolicy(agent, env_cfg)),
                         ("rl (cpu)", RLDispatchPolicy(cpu_agent, env_cfg))):
        t0 = time.perf_counter()
        results[name] = ClusterSimulator(policy, cfg()).run(trace)
        secs[name] = time.perf_counter() - t0

    def records(res):
        return [dataclasses.asdict(r) for r in res.jobs]

    if (results["rl"].summary() != results["rl (cpu)"].summary()
            or records(results["rl"]) != records(results["rl (cpu)"])):
        fail("the RL policy's run with the agent on the card differs from the CPU's")

    pol = RLDispatchPolicy(agent, env_cfg)
    retrainer = OnlineRetrainer(policy=pol, train_cfg=default_retrain_train_config(240),
                                interval_s=ONLINE_RETRAIN_S)
    cycle_s = []

    def on_tick(now, sim):
        t0, before = time.perf_counter(), len(retrainer.history)
        retrainer(now, sim)
        if len(retrainer.history) > before:
            cycle_s.append(time.perf_counter() - t0)

    tel = Telemetry()
    t0 = time.perf_counter()
    results["rl+retrain"] = ClusterSimulator(pol, cfg(tick=retrainer.interval_s),
                                             on_tick=on_tick, telemetry=tel).run(trace)
    secs["rl+retrain"] = time.perf_counter() - t0

    ts = results["time_sharing"].throughput
    say(f"[6] {'policy':14s} {'throughput':>10s} {'vs_ts':>6s} {'makespan_h':>10s} "
        f"{'mean_wait_m':>11s} {'p99_wait_m':>10s} {'slice_util':>10s} {'backfills':>9s} "
        f"{'seconds':>8s}")
    for name, r in results.items():
        say(f"[6] {name:14s} {r.throughput:10.3f} {r.throughput / ts:6.3f} "
            f"{r.makespan / 3600:10.2f} {r.mean_wait / 60:11.1f} {r.p99_wait / 60:10.1f} "
            f"{r.slice_utilization:10.3f} {r.backfills:9d} {secs[name]:8.1f}")
    say(f"[6] rl on the card == rl on the CPU: summary and {len(results['rl'].jobs)} job "
        f"records key for key  ({card})")
    say(f"[6] re-training cycles: {len(retrainer.history)}")
    for h, sec in zip(retrainer.history, cycle_s):
        say(f"[6]   t={h['t_s'] / 60:6.0f}min repo={h['repository_jobs']:3d} jobs "
            f"{h['class_counts']} train_tp={h['train_eval_throughput']:.3f} "
            f"({h['episodes']} episodes on the card in {sec:.1f} s)")
    if not results["rl"].throughput >= 0.99 * ts:
        fail(f"rl throughput {results['rl'].throughput:.4f} below 0.99 x time sharing's "
             f"{ts:.4f}")
    if not retrainer.history or pol.agent is agent:
        fail("the retrainer never fired or never hot-swapped the agent")
    res, m = results["rl+retrain"], {d["name"]: d for d in tel.metrics.to_dicts()}
    summ = res.summary()
    agree = (m["jobs_arrived"]["value"] == summ["jobs"]
             and m["windows_formed"]["value"] == summ["dispatches"]
             and m["groups_placed"]["value"] == summ["groups"]
             and m["backfills"]["value"] == summ["backfills"]
             and m["wait_s"]["count"] == summ["jobs"]
             and math.isclose(m["wait_s"]["sum"], sum(r.wait for r in res.jobs), rel_tol=1e-9)
             and math.isclose(m["busy_unit_s"]["value"], sum(res.slice_busy_s), rel_tol=1e-9))
    if not agree:
        fail("the telemetry registry's aggregates differ from summary()")
    say(f"[6] telemetry: {len(tel.recorder)} lifecycle events; the registry's counters equal "
        f"summary() (jobs {summ['jobs']}, windows {summ['dispatches']}, groups "
        f"{summ['groups']}, backfills {summ['backfills']}), wait and busy sums within 1e-9")
    return trace, results


# phase 7: the vectorized simulator (online/vecsim.py) on the card, at phase 6's
# settings; its sweep is the trace family of benchmarks/online_sim.py
SWEEP_TRACES, SWEEP_CAPACITY = 64, 128
FLEET_PODS = (8, 8, 4, 4)


def close(a: float, b: float) -> bool:
    """f32 lanes against the heap's f64 clock (tests/strategies.py's bound)."""
    return abs(a - b) <= max(0.05, 1e-4 * max(abs(a), abs(b)))


def check_parity(heap, vec, what: str) -> None:
    """The engine's decisions equal the heap's; times to f32 resolution."""
    key = lambda r: (r.arrival, r.name)  # noqa: E731
    if len(heap.jobs) != len(vec.jobs):
        fail(f"{what}: {len(vec.jobs)} records against the heap's {len(heap.jobs)}")
    for a, b in zip(sorted(heap.jobs, key=key), sorted(vec.jobs, key=key)):
        if ((a.name, a.units, a.partition, a.group_size, a.backfilled, a.pod)
                != (b.name, b.units, b.partition, b.group_size, b.backfilled, b.pod)
                or not close(a.dispatch, b.dispatch) or not close(a.finish, b.finish)):
            fail(f"{what}: job {a.name} at {a.arrival:.1f} s differs from the heap's: "
                 f"{dataclasses.asdict(b)} against {dataclasses.asdict(a)}")
    if (heap.dispatches, heap.backfills, heap.refits) != (vec.dispatches, vec.backfills,
                                                          vec.refits):
        fail(f"{what}: windows / backfills / refits {vec.dispatches} / {vec.backfills} / "
             f"{vec.refits} against the heap's {heap.dispatches} / {heap.backfills} / "
             f"{heap.refits}")
    if [(s.slices, s.partition, s.backfilled, s.pod) for s in heap.timeline] != \
            [(s.slices, s.partition, s.backfilled, s.pod) for s in vec.timeline]:
        fail(f"{what}: the timeline's slice ranges differ from the heap's")


def check_rows(summ, rows: dict, what: str) -> None:
    """Sweep lanes against single-trace runs (``rows``: lane -> SimResult)."""
    for i, res in rows.items():
        s = res.summary()
        for field, key in (("makespan", "makespan_s"), ("mean_wait", "mean_wait_s"),
                           ("p99_wait", "p99_wait_s"), ("throughput", "throughput")):
            if not close(float(getattr(summ, field)[i]), s[key]):
                fail(f"{what}: lane {i} {field} {float(getattr(summ, field)[i])} against the "
                     f"single run's {s[key]}")
        if (int(summ.dispatches[i]), int(summ.backfills[i])) != (s["dispatches"], res.backfills):
            fail(f"{what}: lane {i}'s windows / backfills differ from the single run's")


def timed(torch, fn):
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def phase_vecsim(torch, card, agent, trace, heap, dev: str = "cuda"):
    """Phase 7: the vectorized cluster simulator on the card at phase 6's
    settings — time sharing and phase 4's agent on phase 6's trace (equal
    to the heap runs of phase 6), sweeps of 64 poisson traces, a population
    of 4 agents, the (8, 8, 4, 4) hash-routed fleet, the rollout collector
    card against CPU, and the re-trainer on the queueing reward.  ``dev``
    is the engines' device (the card; a dry run of the script's logic may
    pass the CPU)."""
    from repro_torch.core import EnvConfig, make_zoo
    from repro_torch.core.agent import DQNAgent
    from repro_torch.online import (
        ClusterSimulator, OnlineRetrainer, RLDispatchPolicy, SimConfig, TimeSharingPolicy,
        VectorizedClusterSimulator, VectorizedFleetSimulator, default_retrain_online_config,
        make_rollout_collector, poisson_trace,
    )
    from repro_torch.online import vecsim as tv

    t_phase = time.perf_counter()
    zoo = make_zoo()
    env_cfg = EnvConfig(window=TRAIN_WINDOW, c_max=4)
    traces = [poisson_trace(zoo, n=ONLINE_ARRIVALS, load=ONLINE_LOAD, seed=s, capacity=1.0)
              for s in range(SWEEP_TRACES)]
    if [a.t for a in traces[0]] != [a.t for a in trace]:
        fail("the sweep's trace 0 is not phase 6's trace")
    probe = (0, SWEEP_TRACES // 3, 2 * SWEEP_TRACES // 3, SWEEP_TRACES - 1)
    say(f"[7] {SWEEP_TRACES} poisson traces (seeds 0-{SWEEP_TRACES - 1}, {ONLINE_ARRIVALS} "
        f"arrivals, load {ONLINE_LOAD}), window {TRAIN_WINDOW}, capacity {SWEEP_CAPACITY}; "
        f"lanes {probe} also run alone")

    # (a) time sharing
    if VectorizedClusterSimulator(TimeSharingPolicy()).device.type != "cuda":
        fail("the vectorized engine does not default to the card")
    ts = VectorizedClusterSimulator(TimeSharingPolicy(), window=TRAIN_WINDOW,
                                    capacity=SWEEP_CAPACITY, device=dev)
    check_parity(heap["time_sharing"], ts.run(trace), "time sharing, card engine")
    summ, sec = timed(torch, lambda: ts.sweep(traces))
    st = ts._runf.stats
    check_rows(summ, {i: ts.run(traces[i]) for i in probe}, "time-sharing sweep")
    n_heap = min(8, SWEEP_TRACES)
    _, heap_sec = timed(torch, lambda: [ClusterSimulator(TimeSharingPolicy(), window=TRAIN_WINDOW)
                                        .run(t) for t in traces[:n_heap]])
    say(f"[7] (a) time sharing: the card engine's run of phase 6's trace equals the heap's "
        f"(decisions exact, times within f32); sweep of {SWEEP_TRACES} traces in {sec:.3f} s "
        f"= {SWEEP_TRACES / sec:.1f} traces/s ({st['iterations']} iterations, "
        f"{1e3 * sec / st['iterations']:.3f} ms each); heap {n_heap / heap_sec:.1f} traces/s on "
        f"this host; lanes {probe} equal their single runs")

    # (b) RL: phase 4's agent
    rl = VectorizedClusterSimulator(RLDispatchPolicy(agent, env_cfg), window=TRAIN_WINDOW,
                                    capacity=SWEEP_CAPACITY, device=dev)
    res_rl, sec1 = timed(torch, lambda: rl.run(trace))
    check_parity(heap["rl"], res_rl, "RL, card engine")
    summ_rl, sec = timed(torch, lambda: rl.sweep(traces))
    st = rl._runf.stats
    check_rows(summ_rl, {i: rl.run(traces[i]) for i in probe}, "RL sweep")
    n_heap = min(4, SWEEP_TRACES)
    _, heap_sec = timed(torch, lambda: [ClusterSimulator(RLDispatchPolicy(agent, env_cfg),
                                                         window=TRAIN_WINDOW).run(t)
                                        for t in traces[:n_heap]])
    say(f"[7] (b) RL: the card engine's run of phase 6's trace ({sec1:.2f} s) equals the heap "
        f"RL run of phase 6; sweep of {SWEEP_TRACES} traces in {sec:.3f} s = "
        f"{SWEEP_TRACES / sec:.2f} traces/s ({st['iterations']} service iterations, "
        f"{st['formations']} formations); heap RL {n_heap / heap_sec:.2f} traces/s on this host; "
        f"mean throughput {float(summ_rl.throughput.mean()):.4f} against time sharing's "
        f"{float(summ.throughput.mean()):.4f}")
    gen = torch.Generator().manual_seed(7)
    pop = [agent.params] + [
        {k: v + 0.02 * torch.randn(v.shape, generator=gen).to(v.device)
         for k, v in agent.params.items()} for _ in range(3)]
    out, sec = timed(torch, lambda: rl.sweep(traces, param_sets=pop))
    st = rl._runf.stats
    for p_i, params in enumerate(pop):
        one = VectorizedClusterSimulator(
            RLDispatchPolicy(DQNAgent(params["w0"].shape[0], params["wA"].shape[1],
                                      params=params, device=dev), env_cfg),
            window=TRAIN_WINDOW, capacity=SWEEP_CAPACITY, device=dev).sweep(traces)
        for name, a, b in zip(out._fields, out, one):
            if not torch.equal(a[p_i], b):
                fail(f"param_sets: agent {p_i}'s {name} differs from its own sweep")
    say(f"[7] (b) param_sets: 4 agents x {SWEEP_TRACES} traces in one call, {sec:.3f} s "
        f"({st['formations']} formations); each agent's rows equal its own sweep bit for bit; "
        f"mean p99 wait (min) by agent: "
        f"{', '.join(f'{x / 60:.1f}' for x in out.p99_wait.mean(dim=1).tolist())}")

    # (c) the hash-routed fleet
    fcfg = SimConfig(window=TRAIN_WINDOW, pods=FLEET_PODS, router="hash")
    for name, make in (("time sharing", TimeSharingPolicy),
                       ("RL", lambda: RLDispatchPolicy(agent, env_cfg))):
        h = ClusterSimulator(make(), fcfg).run(trace)
        v, sec = timed(torch, lambda: VectorizedFleetSimulator(
            make(), fcfg, capacity=SWEEP_CAPACITY, device=dev).run(trace))
        check_parity(h, v, f"fleet {FLEET_PODS}, {name}")
        say(f"[7] (c) fleet {FLEET_PODS} 'hash', {name}: equals the heap fleet "
            f"({v.dispatches} windows, {v.backfills} backfills, {v.refits} refits, "
            f"throughput {v.throughput:.3f}; {sec:.2f} s)")

    # (d) training on the queueing reward: the collector card against CPU
    B = min(8, SWEEP_TRACES)
    names, jobs = {}, []
    compiled = [tv.compile_trace(t, SWEEP_CAPACITY, names, jobs, device="cpu")[0]
                for t in traces[:B]]
    n_act = env_cfg.window + len(tv.enumerate_partitions(env_cfg.c_max))
    g = torch.Generator().manual_seed(11)
    ue = torch.rand((B, SWEEP_CAPACITY, 2 * env_cfg.window), generator=g)
    us = torch.rand((B, SWEEP_CAPACITY, 2 * env_cfg.window, n_act), generator=g)
    rolls = []
    for on in (dev, "cpu"):
        collect = make_rollout_collector(env_cfg, window=TRAIN_WINDOW, capacity=SWEEP_CAPACITY,
                                         device=on)
        params = {k: v.to(on) for k, v in agent.params.items()}
        out, sec = timed(torch, lambda: collect(
            tv.stack_traces(compiled, on), tv.build_rl_job_table(jobs, on), params, 0.25,
            torch.full((B,), 8, device=on), u_explore=ue, u_scores=us))
        rolls.append(out)
        say(f"[7] (d) rollout collector on {on}: {B} traces at eps 0.25 in {sec:.2f} s")
    (sc, rc), (sp, rp) = rolls
    for f in ("valid", "act", "mask"):
        if not torch.equal(getattr(rc, f).cpu(), getattr(rp, f)):
            fail(f"the collector's {f} on the card differs from the CPU's")
    err = max(float(((getattr(rc, f).cpu() - getattr(rp, f)).abs()
                     / getattr(rp, f).abs().clamp_min(1.0)).max()) for f in ("w_wait", "w_turn"))
    if err > 1e-5:
        fail(f"the collector's buckets on the card differ from the CPU's by {err:.2e}")
    say(f"[7] (d) card == CPU: {int(rp.valid.sum())} decisions' actions, masks and valid flags "
        f"equal; wait / turnaround buckets within {err:.2e} relative (bound 1e-5)")

    # (d) the re-trainer on the queueing reward, phase 6's trace
    warm = DQNAgent(agent.params["w0"].shape[0], agent.params["wA"].shape[1],
                    params={k: v.clone() for k, v in agent.params.items()}, device=dev)
    pol = RLDispatchPolicy(warm, env_cfg)
    retrainer = OnlineRetrainer(policy=pol, reward="queueing",
                                online_cfg=default_retrain_online_config(),
                                interval_s=ONLINE_RETRAIN_S)
    cycle_s = []

    def on_tick(now, sim):
        t0, before = time.perf_counter(), len(retrainer.history)
        retrainer(now, sim)
        if len(retrainer.history) > before:
            cycle_s.append(time.perf_counter() - t0)

    res, sec = timed(torch, lambda: ClusterSimulator(
        pol, SimConfig(window=TRAIN_WINDOW, tick_interval_s=ONLINE_RETRAIN_S),
        on_tick=on_tick).run(trace))
    if not retrainer.history or pol.agent is warm:
        fail("the queueing-reward retrainer never fired or never hot-swapped the agent")
    for h, c in zip(retrainer.history, cycle_s):
        kept = "the incumbent" if h["selected"] == "warm_start" else "the refresh"
        say(f"[7] (d)   t={h['t_s'] / 60:6.0f}min repo={h['repository_jobs']:3d} jobs: "
            f"{h['rounds']} rounds in {c:.1f} s, eval p99 wait "
            f"{h['train_eval_p99_wait'] / 60:.1f} min, guard kept {kept}")
    ts_tp = heap["time_sharing"].throughput
    say(f"[7] (d) rl + queueing retrain: throughput {res.throughput:.3f} = "
        f"{res.throughput / ts_tp:.3f} x time sharing (rl alone "
        f"{heap['rl'].throughput / ts_tp:.3f}), mean wait {res.mean_wait / 60:.1f} min, "
        f"p99 {res.p99_wait / 60:.1f} min; {len(retrainer.history)} cycles, run {sec:.1f} s")
    say(f"[7] phase 7 took {time.perf_counter() - t_phase:.1f} s  ({card})")


# ---------------------------------------------------------------------------
# phase 8: serving the moe, hybrid and vlm families
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ("deepseek-moe-16b", "qwen2-moe-a2.7b", "jamba-v0.1-52b", "chameleon-34b")
MOE_JOB = ("qwen2-moe-a2.7b", "decode_32k", 16, 8)     # the zoo's job: batch 8, 4096 slots
SERVE_ARGV = ["--arch", "deepseek-moe-16b", "--scale", "full", "--batch", "4", "--gen", "32"]
JAMBA_BLOCKS = 1          # of jamba-v0.1-52b's 4 super-blocks of 8 layers
CHAMELEON_LAYERS = 16     # of chameleon-34b's 48
FAMILY_STEPS = 16         # decode steps of (d) and (e)
FAMILY_BATCH = 8          # (d)'s decode batch


def free(torch) -> None:
    """Collect what was dropped and empty the caching allocator, so that
    the next model finds the card's memory free."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def grow_cache(cache: dict, smax: int) -> dict:
    """A dense prefill's S-slot cache (L, B, S, Hkv, D) grown to ``smax``
    slots, zeros past S, as ``examples/serve_decode.py`` grows it to its
    horizon."""
    out = {}
    for k, v in cache.items():
        out[k] = v.new_zeros((*v.shape[:2], smax, *v.shape[3:]))
        out[k][:, :, :v.shape[2]] = v
    return out


def timed_steps(torch, n: int, step) -> list[float]:
    """``step()`` ``n`` times, each synchronized: its ms."""
    ms = []
    for _ in range(n):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return ms


def median(xs: list[float]) -> float:
    return sorted(xs)[len(xs) // 2]


def rel_close(got: float, ref: float, tol: float) -> bool:
    return got == ref or abs(got - ref) <= tol * abs(ref)


def phase_families_reference(torch):
    """(a) The four archs' smoke configs at D=128 (the kernels' D), f32 with
    TF32 off, on the card against the CPU: the loss forward with its MoE
    aux, then ``prefill`` and 8 ``decode_step``s."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as tm
    from repro_torch.optim import tree_map

    B, S, steps = 2, 40, 8
    for arch in FAMILY_ARCHS:
        cfg = get_smoke_config(arch).replace(d_head=128, dtype="float32")
        cpu = tm.init_params(cfg, seed=14, device="cpu")
        gpu = tree_map(lambda t: t.cuda(), cpu)
        gen = torch.Generator().manual_seed(15)
        tokens = torch.randint(0, cfg.vocab_size, (B, S + steps), generator=gen)
        labels = torch.roll(tokens[:, :S], -1, 1)
        labels[:, -1] = -1
        out = {}
        for dev, params in (("cpu", cpu), ("cuda", gpu)):
            batch = {"tokens": tokens[:, :S].to(dev), "labels": labels.to(dev)}
            with torch.no_grad():
                total, _ = tm.loss_fn(params, batch, cfg)
                _, aux = tm.forward_train(params, batch, cfg)
            out[dev] = {"loss": total.item(), **{k: v.item() for k, v in aux.items()}}
        c, g = out["cpu"], out["cuda"]
        # phase 5 (a)'s loss bound for the losses, the drop fraction equal,
        # phase 5 (e)'s bound for the logits rows
        bad = [k for k in ("loss", "moe_aux", "moe_z") if not rel_close(g[k], c[k], LM_LOSS_TOL)]
        if bad or g["moe_drop_frac"] != c["moe_drop_frac"]:
            fail(f"{cfg.name}: loss forward on the card {g} differs from the CPU's {c}")

        lc, cc = tm.prefill(cpu, tokens[:, :S], cfg, S)
        lg, cg = tm.prefill(gpu, tokens[:, :S].cuda(), cfg, S)
        worst = row_rel_err(torch, lg.cpu(), lc)
        if cfg.family == "hybrid":     # a fresh cache, as the reference's prefill gives
            cc, cg = tm.init_cache(cpu, cfg, B, S + steps), tm.init_cache(gpu, cfg, B, S + steps)
        else:
            cc, cg = grow_cache(cc, S + steps), grow_cache(cg, S + steps)
        for t in range(steps):
            pos = torch.full((B,), S + t, dtype=torch.int32)
            l1, cc = tm.decode_step(cpu, cc, tokens[:, S + t], pos, cfg)
            l2, cg = tm.decode_step(gpu, cg, tokens[:, S + t].cuda(), pos.cuda(), cfg)
            worst = max(worst, row_rel_err(torch, l2.cpu(), l1))
        say(f"[8] (a) {cfg.name} (D=128, f32, TF32 off, {B} x {S} tokens): card == CPU: loss "
            f"{g['loss']:.6f} vs {c['loss']:.6f}, moe_aux {g['moe_aux']:.6e} vs "
            f"{c['moe_aux']:.6e}, moe_z {g['moe_z']:.6e} vs {c['moe_z']:.6e} (bound "
            f"{LM_LOSS_TOL:g} relative), moe_drop_frac {g['moe_drop_frac']!r} == "
            f"{c['moe_drop_frac']!r}; prefill + {steps} decode steps logits row relative "
            f"{worst:.2e} (bound {ROW_TOL['float32']:g})")
        if not worst <= ROW_TOL["float32"]:
            fail(f"{cfg.name}: logits on the card differ from the CPU's")


def phase_moe_pair(torch, card):
    """(b) The zoo's qwen2-moe-a2.7b decode job (batch 8 against a
    4096-slot cache at ragged lengths, share 0.25, 8 steps) beside phase
    3's llama3-8b prefill tenant (1 x 8192, share 0.75, 12 steps) on two
    streams, then each alone; then one decode step profiled."""
    from repro_torch.configs import SHAPES, get_config, scaled_shape
    from repro_torch.models.model import count_params_analytic
    from repro_torch.runtime.multitenant import Tenant

    arch, shape_name, bdiv, sdiv = MOE_JOB
    cfg = get_config(arch)
    dec_shape = scaled_shape(SHAPES[shape_name], bdiv, sdiv)
    say(f"[8] (b) {cfg.name}: d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.d_head}, {cfg.moe.n_routed} routed experts top-{cfg.moe.top_k} of "
        f"{cfg.moe.d_expert} + {cfg.moe.n_shared} shared, {cfg.n_layers} of {cfg.n_layers} layers "
        f"(no cut), {count_params_analytic(cfg) / 1e9:.2f} B params, {cfg.dtype}; the zoo's job "
        f"{MOE_JOB}: batch {dec_shape.global_batch} against {dec_shape.seq_len} slots")
    steps = {"prefill": PREFILL_STEPS, "decode": DECODE_STEPS}
    # llama3-8b's 32 layers launch flash once each a prefill step
    expect = {"flash_attention": 32 * PREFILL_STEPS,
              "decode_attention": cfg.n_layers * DECODE_STEPS, "rmsnorm": 0}

    def prefill_tenant(stream):
        p_cfg, pre, fn = make_prefill(torch, stream)
        with torch.cuda.stream(stream):
            fn(None)                                     # warm-up
        return Tenant(f"{p_cfg.name}:{pre.name}", fn, None, SHARES["prefill"], stream=stream)

    def decode_tenant(stream):
        t = make_decode(torch, cfg, SHARES["decode"], stream, dec_shape)
        with torch.cuda.stream(stream):
            t.step_fn(t.state)                           # warm-up; the state is kept
        return t

    makers = {"prefill": prefill_tenant, "decode": decode_tenant}

    def run(roles):
        free(torch)
        return run_group(torch, {r: makers[r] for r in roles}, steps,
                         lambda r, t: t.state[2] if r == "decode" else t.state)

    names, finish, co, quanta, launches, peak = run(("prefill", "decode"))
    say(f"[8] (b) co-run on two streams, quanta {quanta}, kernel launches {launches} (expected "
        f"{expect}), peak device memory {peak:.1f} GiB")
    if launches != expect:
        fail(f"the MoE pair's co-run launched {launches} kernels, expected {expect}")
    solo, solo_out = {}, {}
    for role in ("prefill", "decode"):
        _, fin, outputs, _, _, solo_peak = run((role,))
        solo[role], solo_out[role] = fin[role], outputs[role]
        say(f"[8] (b) {names[role]} alone: {solo[role]:.3f} s ({1e3 * solo[role] / steps[role]:.1f}"
            f" ms a step), peak device memory {solo_peak:.1f} GiB")
    for role, name in names.items():
        say(f"[8] (b) {name}: co-run finish {finish[role]:.3f} s, solo {solo[role]:.3f} s, "
            f"slowdown {finish[role] / solo[role]:.3f}  ({card})")
    makespan, ts = max(finish.values()), sum(solo.values())
    say(f"[8] (b) co-run makespan {makespan:.3f} s / time sharing {ts:.3f} s = "
        f"{makespan / ts:.3f}  ({card})")
    for role, name in names.items():
        got, ref = co[role], solo_out[role]
        if got.shape != ref.shape or not torch.isfinite(got).all():
            fail(f"{name}: logits of shape {tuple(got.shape)} or non-finite")
        rel = row_rel_err(torch, got, ref)
        say(f"[8] (b) {name}: logits {tuple(got.shape)} finite; co-run vs solo row relative "
            f"{rel:.3e} (bound {ROW_TOL['bfloat16']:g})")
        if not rel <= ROW_TOL["bfloat16"]:
            fail(f"{name}: co-run logits differ from the solo run's")

    free(torch)
    stream = torch.cuda.Stream()
    tenant = decode_tenant(stream)
    state = tenant.state
    with torch.cuda.stream(stream):
        ms = timed_steps(torch, DECODE_STEPS, lambda: tenant.step_fn(state))
        n, busy = device_launches(torch, lambda: tenant.step_fn(state))
    step_ms = median(ms)
    say(f"[8] (b) {names['decode']} alone, one step at a time: median {step_ms:.2f} ms a step "
        f"(synchronized; {', '.join(f'{x:.1f}' for x in ms)}), {n} device launches and "
        f"{busy:.2f} ms of device time a step (profiled): idle share {1 - busy / step_ms:.3f}  "
        f"({card})")
    return launches


def phase_serve_entry(torch, card):
    """(c) ``launch/serve.py`` at deepseek-moe-16b's full width and depth."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.model import count_params_analytic

    cfg = get_config("deepseek-moe-16b")
    gen = int(SERVE_ARGV[SERVE_ARGV.index("--gen") + 1])
    expect = {"flash_attention": 0, "decode_attention": cfg.n_layers * gen, "rmsnorm": 0}
    free(torch)
    torch.cuda.reset_peak_memory_stats()
    say(f"[8] (c) python -m repro_torch.launch.serve {' '.join(SERVE_ARGV)}: {cfg.name}, "
        f"{cfg.n_layers} of {cfg.n_layers} layers, {cfg.moe.n_routed} routed experts "
        f"top-{cfg.moe.top_k} + {cfg.moe.n_shared} shared, "
        f"{count_params_analytic(cfg) / 1e9:.2f} B params, {cfg.dtype}:")
    reset_launches()
    t0 = time.perf_counter()
    logits = serve.main(SERVE_ARGV)
    launches = read_launches()
    say(f"[8] (c) {time.perf_counter() - t0:.1f} s with the weights' init; kernel launches "
        f"{launches} (expected {expect}); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB  ({card})")
    if launches != expect:
        fail(f"serve launched {launches} kernels, expected {expect}")
    if not torch.isfinite(logits).all():
        fail("serve: the last logits are not finite")
    return launches


def phase_jamba(torch, card):
    """(d) jamba-v0.1-52b at its published widths, cut to JAMBA_BLOCKS of
    its super-blocks: ``make_prefill_step`` on 1 x 8192 tokens, then 16
    steps of ``make_decode_step`` at batch 8 against a 32768-slot cache."""
    from repro_torch.configs import SHAPES, get_config, scaled_shape
    from repro_torch.models import model as tm
    from repro_torch.runtime.steps import make_decode_step, make_prefill_step

    full = get_config("jamba-v0.1-52b")
    cfg = full.replace(n_layers=JAMBA_BLOCKS * full.attn_every)
    shape = scaled_shape(SHAPES["prefill_32k"], 32, 4)           # 1 x 8192 tokens
    free(torch)
    torch.cuda.reset_peak_memory_stats()
    say(f"[8] (d) {cfg.name}: d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.d_head}, Mamba d_inner {cfg.mamba.expand * cfg.d_model} d_state "
        f"{cfg.mamba.d_state} chunks of {cfg.mamba.chunk}, {cfg.moe.n_routed} experts "
        f"top-{cfg.moe.top_k} of {cfg.moe.d_expert} every {cfg.moe.every}, {cfg.dtype}; cut to "
        f"{JAMBA_BLOCKS} of {full.n_layers // full.attn_every} super-blocks ({cfg.n_layers} of "
        f"{full.n_layers} layers): {tm.count_params_analytic(cfg) / 1e9:.2f} B params "
        f"({2 * tm.count_params_analytic(full) / 1e9:.1f} GB in bf16 for the whole "
        f"{tm.count_params_analytic(full) / 1e9:.2f} B, more than one card holds)")
    t0 = time.perf_counter()
    params = tm.init_params(cfg, seed=16)
    gen = torch.Generator("cuda").manual_seed(17)
    tokens = torch.randint(0, cfg.vocab_size, (shape.global_batch, shape.seq_len), generator=gen,
                           device="cuda")
    torch.cuda.synchronize()
    say(f"[8] (d) set-up {time.perf_counter() - t0:.1f} s")
    prefill, out = make_prefill_step(cfg, shape), {}
    prefill(params, tokens)                                      # warm-up
    reset_launches()
    ms = timed_steps(torch, 1, lambda: out.update(r=prefill(params, tokens)))
    launches = read_launches()
    logits, _ = out.pop("r")
    with torch.no_grad():
        _, aux = tm.forward_train(params, {"tokens": tokens}, cfg)
    n_moe = JAMBA_BLOCKS * cfg.attn_every // cfg.moe.every
    say(f"[8] (d) prefill {shape.global_batch} x {shape.seq_len}: {ms[0]:.1f} ms (synchronized), "
        f"flash launches {launches['flash_attention']}; moe_drop_frac "
        f"{aux['moe_drop_frac'].item():.4f} summed over its {n_moe} MoE layers (capacity "
        f"factor {cfg.moe.capacity_factor})  ({card})")
    if launches["flash_attention"] != JAMBA_BLOCKS or not torch.isfinite(logits).all():
        fail(f"jamba prefill: {launches} launches, or non-finite logits")

    smax = SHAPES["decode_32k"].seq_len
    dec = make_decode_step(cfg, FAMILY_BATCH, smax)
    cache = dec.init_cache(params)
    cache["attn"]["k"].normal_(generator=gen)
    cache["attn"]["v"].normal_(generator=gen)
    start = ragged_starts(FAMILY_BATCH, smax, FAMILY_STEPS)
    pos = torch.tensor(start, dtype=torch.int32, device="cuda")
    tok = torch.randint(0, cfg.vocab_size, (FAMILY_BATCH,), generator=gen, device="cuda")
    state = {"tok": tok, "pos": pos, "finite": torch.ones((), dtype=torch.bool, device="cuda")}

    def step():
        logits, _ = dec(params, cache, state["tok"], state["pos"])
        state.update(tok=logits.argmax(dim=-1), pos=state["pos"] + 1, logits=logits,
                     finite=state["finite"] & torch.isfinite(logits).all())

    reset_launches()
    ms = timed_steps(torch, FAMILY_STEPS, step)
    dlaunches = read_launches()
    if not state["finite"].item() or dlaunches["decode_attention"] != JAMBA_BLOCKS * FAMILY_STEPS:
        fail(f"jamba decode: {dlaunches} launches, or non-finite logits")
    last = state["pos"] - 1                                      # re-write the last slot
    n, busy = device_launches(torch, lambda: dec(params, cache, state["tok"], last))
    say(f"[8] (d) decode batch {FAMILY_BATCH} against {smax} slots (attention cache at ragged "
        f"lengths {start}, zero Mamba state): {FAMILY_STEPS} steps of "
        f"{', '.join(f'{x:.1f}' for x in ms)} ms (median {median(ms):.2f}), {n} device launches "
        f"and {busy:.2f} ms of device time a step: idle share {1 - busy / median(ms):.3f}; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB  ({card})")
    return {k: launches[k] + dlaunches[k] for k in launches}


def phase_chameleon(torch, card):
    """(e) chameleon-34b at its published widths, cut to CHAMELEON_LAYERS
    layers: prefill 1 x 4096, the cache grown to the horizon, 16 decode
    steps; then the QK-norm cache: a prefill of S - 1 tokens and a decode
    of token S - 1 against the last logits of the prefill of all S, in
    bf16 and in f32."""
    from repro_torch.configs import SHAPES, get_config, scaled_shape
    from repro_torch.models import model as tm
    from repro_torch.runtime.steps import make_decode_step, make_prefill_step

    full = get_config("chameleon-34b")
    cfg = full.replace(n_layers=CHAMELEON_LAYERS)
    shape = scaled_shape(SHAPES["prefill_32k"], 32, 8)           # 1 x 4096 tokens
    S = shape.seq_len
    free(torch)
    torch.cuda.reset_peak_memory_stats()
    say(f"[8] (e) {cfg.name}: d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.d_head} with QK-norm, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}; cut to "
        f"{cfg.n_layers} of {full.n_layers} layers: {tm.count_params_analytic(cfg) / 1e9:.2f} B "
        f"params (the whole {tm.count_params_analytic(full) / 1e9:.2f} B is "
        f"{2 * tm.count_params_analytic(full) / 1e9:.1f} GB in bf16)")
    params = tm.init_params(cfg, seed=18)
    gen = torch.Generator("cuda").manual_seed(19)
    tokens = torch.randint(0, cfg.vocab_size, (1, S), generator=gen, device="cuda")
    prefill, out = make_prefill_step(cfg, shape), {}
    prefill(params, tokens)                                      # warm-up
    reset_launches()
    ms = timed_steps(torch, 1, lambda: out.update(r=prefill(params, tokens)))
    launches = read_launches()
    logits_full, cache = out.pop("r")
    cache = grow_cache(cache, S + FAMILY_STEPS)
    dec = make_decode_step(cfg, 1, S + FAMILY_STEPS)
    state = {"tok": logits_full.argmax(dim=-1),
             "pos": torch.full((1,), S, dtype=torch.int32, device="cuda"),
             "finite": torch.isfinite(logits_full).all()}

    def step():
        logits, _ = dec(params, cache, state["tok"], state["pos"])
        state.update(tok=logits.argmax(dim=-1), pos=state["pos"] + 1, logits=logits,
                     finite=state["finite"] & torch.isfinite(logits).all())

    reset_launches()
    dms = timed_steps(torch, FAMILY_STEPS, step)
    dlaunches = read_launches()
    say(f"[8] (e) prefill 1 x {S}: {ms[0]:.1f} ms (synchronized), {launches['flash_attention']} "
        f"flash launches; {FAMILY_STEPS} decode steps against the grown cache of "
        f"{S + FAMILY_STEPS} slots: {', '.join(f'{x:.1f}' for x in dms)} ms (median "
        f"{median(dms):.2f}); peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} "
        f"GiB  ({card})")
    if (launches["flash_attention"] != cfg.n_layers
            or dlaunches["decode_attention"] != cfg.n_layers * FAMILY_STEPS
            or not state["finite"].item()):
        fail(f"chameleon: launches {launches}, {dlaunches} or non-finite logits")

    last = state["pos"] - 1                                      # re-write the last slot
    n, busy = device_launches(torch, lambda: dec(params, cache, state["tok"], last))
    say(f"[8] (e) a decode step: {n} device launches and {busy:.2f} ms of device time: idle "
        f"share {1 - busy / median(dms):.3f}  ({card})")

    # the QK-norm cache: prefill S - 1 tokens, decode token S - 1, against
    # the last logits of the prefill of all S.  In bf16 the two orders of
    # rounding part by ~1.3e-2, as much as the same weights part without
    # the QK-norm (the dense family; both printed); in f32 the same model
    # at the same width must agree within ROW_TOL["float32"].
    del cache
    rels = {"bfloat16": continuation_err(torch, cfg, params, tokens, shape, logits_full),
            "bfloat16, no QK-norm": continuation_err(torch, cfg.replace(family="dense"), params,
                                                     tokens, shape)}
    del params, logits_full
    free(torch)
    f32 = cfg.replace(dtype="float32")
    params = tm.init_params(f32, seed=18)                        # the same draws, unrounded
    rels["float32"] = continuation_err(torch, f32, params, tokens, shape)
    say(f"[8] (e) QK-norm cache: prefill {S - 1} tokens + decode token {S - 1} against the "
        f"prefill of all {S}, last logits row relative: bf16 {rels['bfloat16']:.3e} (two "
        f"orders of bf16 rounding, not bounded; the same weights without the QK-norm "
        f"{rels['bfloat16, no QK-norm']:.3e}), f32 {rels['float32']:.3e} (bound "
        f"{ROW_TOL['float32']:g}); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    if not rels["float32"] <= ROW_TOL["float32"]:
        fail("chameleon: the continuation after a prefill differs from teacher forcing")
    return {k: launches[k] + dlaunches[k] for k in launches}


def continuation_err(torch, cfg, params, tokens, shape, logits_full=None) -> float:
    """Row relative error of a prefill of S - 1 tokens and a decode of
    token S - 1 (the cache grown to S) against the last logits of a
    prefill of all S (given, or run here)."""
    from repro_torch.runtime.steps import make_decode_step, make_prefill_step

    S = shape.seq_len
    if logits_full is None:
        logits_full, _ = make_prefill_step(cfg, shape)(params, tokens)
    short = dataclasses.replace(shape, name=f"{shape.name}-1", seq_len=S - 1)
    _, cache = make_prefill_step(cfg, short)(params, tokens[:, :S - 1])
    pos = torch.full((1,), S - 1, dtype=torch.int32, device="cuda")
    logits, _ = make_decode_step(cfg, 1, S)(params, grow_cache(cache, S), tokens[:, S - 1], pos)
    return row_rel_err(torch, logits, logits_full)


def phase_families(torch, card):
    """Phase 8; returns the kernel launches of its main paths (b)-(e)."""
    t_phase = time.perf_counter()
    phase_families_reference(torch)
    runs = [phase_moe_pair(torch, card), phase_serve_entry(torch, card),
            phase_jamba(torch, card), phase_chameleon(torch, card)]
    free(torch)
    launches = {name: sum(r[name] for r in runs) for name in runs[0]}
    say(f"[8] phase 8 took {time.perf_counter() - t_phase:.1f} s, launches on its main paths "
        f"{launches}  ({card})")
    return launches


def main() -> None:
    t_start = time.perf_counter()
    import torch

    card = phase_card(torch)
    recs = phase_kernels(torch, card)
    phase_schedule(card)
    pair = phase_pair(torch, card)
    phase_reference(torch)
    train, agent = phase_train(torch, card)
    phase_lm_reference(torch)
    phase_lm_train(torch, card)
    lm_pair = phase_lm_pair(torch, card)
    step4 = phase_step4_pair(torch, card)
    phase_xlstm_reference(torch, card)
    trace, heap = phase_online(torch, card, agent)
    phase_vecsim(torch, card, agent, trace, heap)
    families = phase_families(torch, card)
    # launches on the main paths: the co-run pair, training the co-scheduler,
    # the train pair, step 4's pair and phase 8's serving runs (no path of
    # the package calls rmsnorm)
    launches = {name: pair[name] + train[name] + lm_pair[name] + step4[name] + families[name]
                for name in pair}
    sources = {"decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                                    "src/repro/kernels/decode_attention/kernel.py:75"),
               "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention/kernel.py:91"),
               "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                           "src/repro/kernels/rmsnorm/kernel.py:29")}
    kernels = []
    for name, (src, replaces) in sources.items():
        r = recs[name]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    say(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
