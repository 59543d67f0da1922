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
   no key).  Decode attention also runs with a row of length 0.  RMSNorm
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

The line before the last is the ``{"kernels": [...]}`` record; the last
line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
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

def make_pair(torch):
    """Set up the co-scheduled llama3-8b pair on the card, one CUDA stream
    per tenant, and warm both up.  Returns ``(steps, tenants)``: the steps
    each tenant runs, and ``tenants(which)``, which makes fresh tenants
    (``which`` names "prefill", "decode" or both) that start from the same
    initial state every time."""
    from repro_torch.configs import SHAPES, get_config, scaled_shape
    from repro_torch.models.model import decode_step, init_cache, init_params, prefill
    from repro_torch.runtime.multitenant import Tenant

    cfg = get_config("llama3-8b")
    pre = scaled_shape(SHAPES["prefill_32k"], 32, 4)       # batch 1 x 8192 tokens
    dec = scaled_shape(SHAPES["decode_32k"], 32, 1)        # batch 4, 32768-slot cache
    say(f"[3] {cfg.name}: d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.d_head}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.n_layers} of "
        f"{cfg.n_layers} layers (no depth cut), {cfg.dtype}; prefill {pre.global_batch}x"
        f"{pre.seq_len}, decode batch {dec.global_batch} cache {dec.seq_len}")
    s_pre, s_dec = torch.cuda.Stream(), torch.cuda.Stream()
    t0 = time.perf_counter()
    with torch.cuda.stream(s_pre):
        p_params = init_params(cfg, seed=1)
        gen = torch.Generator("cuda").manual_seed(21)
        tokens = torch.randint(0, cfg.vocab_size, (pre.global_batch, pre.seq_len),
                               generator=gen, device="cuda")
    with torch.cuda.stream(s_dec):
        d_params = init_params(cfg, seed=2)
        cache = init_cache(d_params, cfg, dec.global_batch, dec.seq_len)
        gen = torch.Generator("cuda").manual_seed(22)
        for i in range(cfg.n_layers):
            cache["k"][i].normal_(generator=gen)
            cache["v"][i].normal_(generator=gen)
        start = [dec.seq_len - DECODE_STEPS, 24577, 16001, 8191][:dec.global_batch]
        if max(start) + DECODE_STEPS > dec.seq_len:
            fail("decode would write past its cache")
        dec_state0 = (torch.randint(0, cfg.vocab_size, (dec.global_batch,), generator=gen,
                                    device="cuda"),
                      torch.tensor(start, dtype=torch.int32, device="cuda"), None)
    torch.cuda.synchronize()
    say(f"[3] set-up {time.perf_counter() - t0:.1f} s (weights from seeded torch.Generators, "
        f"cache filled at ragged lengths {start})")

    def prefill_fn(state):
        logits, _ = prefill(p_params, tokens, cfg, pre.seq_len)
        return logits

    def decode_fn(state):
        tok, pos, _ = state
        logits, _ = decode_step(d_params, cache, tok, pos, cfg)
        return logits.argmax(dim=-1), pos + 1, logits

    names = {"prefill": f"{cfg.name}:{pre.name}", "decode": f"{cfg.name}:{dec.name}"}
    steps = {names["prefill"]: PREFILL_STEPS, names["decode"]: DECODE_STEPS}

    def tenants(which):
        out = []
        if "prefill" in which:
            out.append(Tenant(names["prefill"], prefill_fn, None, SHARES["prefill"], stream=s_pre))
        if "decode" in which:
            out.append(Tenant(names["decode"], decode_fn, dec_state0, SHARES["decode"],
                              stream=s_dec))
        return out

    # warm-up: one step of each on its stream (cuBLAS handles, first kernel loads)
    with torch.cuda.stream(s_pre):
        prefill_fn(None)
    with torch.cuda.stream(s_dec):
        decode_fn(dec_state0)
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
    return launches


def main() -> None:
    t_start = time.perf_counter()
    import torch

    card = phase_card(torch)
    recs = phase_kernels(torch, card)
    phase_schedule(card)
    pair = phase_pair(torch, card)
    phase_reference(torch)
    train = phase_train(torch, card)
    # launches on the main paths: the co-run pair and training (no path of
    # the package calls rmsnorm)
    launches = {name: pair[name] + train[name] for name in pair}
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
