"""One run of one cell: set-up, the measured window, the traced part, the
correctness check and the result line.

The cell, its configuration, its traffic mix, its limits and its metrics'
readers are all found by name from ``BENCHMARK.json``:

    configs/<config>.json   the model's sizes as run (``ModelConfig`` fields)
    traffic/<traffic>.json  the tenants (``tenants.py``)
    limits/<cell>.json      the limit of each number the check compares
    metrics/<metric>.py     ``read(ctx) -> float | None``, the file named
                            by the metric's whole name (``mfu.train`` is
                            ``metrics/mfu.train.py``)

The window drives ``repro_torch.runtime.multitenant.FusedCoRunner.run``,
one macro-step a call, until ``seconds`` are spent; every completed
macro-step counts.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from portbench import check, inputs, tenants as tenant_kinds
from portbench.trace import Trace

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
TRACED_MACRO_STEPS = 2
ALONE_ROUNDS = 2
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start_ticks / os.sysconf("SC_CLK_TCK")


def load_spec(workload: str, root: Path = ROOT) -> dict:
    """The cell ``workload`` of ``BENCHMARK.json`` with its configuration,
    traffic, limits and metric entries."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"portbench: no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])

    def mine(m):
        return workload in m.get("workloads", [workload])

    return {
        "cell": cell,
        "config": json.loads((root / conf["file"]).read_text()),
        "traffic": json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text()),
        "limits": json.loads((HERE / "limits" / f"{workload}.json").read_text()),
        "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
        "per_layer": [m for m in bench["per_layer"] if mine(m)],
    }


def model_config(c: dict):
    """The program's ``ModelConfig`` of a configuration file."""
    from repro_torch.configs.base import ModelConfig, MoECfg

    names = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in c.items() if k in names}
    if "moe" in kw:
        kw["moe"] = MoECfg(**kw["moe"])
    return ModelConfig(**kw)


def sample_rows(seed: int, index: int, n_rows: int, batch: int, longest: int) -> list[int]:
    """``n_rows`` rows drawn from the seed, the ``longest`` among them."""
    rng = np.random.default_rng(inputs.sub_seed(seed, 500 + index))
    others = [r for r in rng.permutation(batch).tolist() if r != longest]
    return sorted([longest] + others[:max(0, n_rows - 1)])


def build_tenants(spec: dict, weights: dict, seed: int, device) -> list:
    c = spec["config"]
    cfg = model_config(c)
    out = []
    for i, td in enumerate(spec["traffic"]["tenants"]):
        lens = td.get("starts") or td.get("enc_lens") or [0] * td["batch"]
        rows = sample_rows(seed, i, td.get("check_rows", td["batch"]), td["batch"],
                           int(np.argmax(lens)))
        out.append(tenant_kinds.KINDS[td["step"]](td, c, cfg, weights, seed, i, device, rows))
    return out


def _launches() -> dict:
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention

    return {"flash": flash_attention.launches, "decode": decode_attention.launches}


class Cell:
    """The tenants of a cell on the executor, with the counts of the work
    each macro-step did."""

    def __init__(self, spec: dict, seed: int, device):
        from repro_torch.models.model import init_params
        from repro_torch.runtime.multitenant import FusedCoRunner, Tenant

        self.spec, self.device = spec, torch.device(device)
        cfg = model_config(spec["config"])
        self.weights = inputs.make_weights(init_params(cfg, device="meta"), seed, device)
        self.tenants = build_tenants(spec, self.weights, seed, device)
        cuda = self.device.type == "cuda"
        self.executor_tenants = [
            Tenant(t.name, t.step, getattr(t, "state0", None), td["share"],
                   stream=torch.cuda.Stream(self.device) if cuda else None)
            for t, td in zip(self.tenants, spec["traffic"]["tenants"])]
        self.runner = FusedCoRunner(self.executor_tenants, {t.name: 0 for t in self.tenants},
                                    spec["traffic"].get("quanta_per_cycle", 4))
        self.quanta = dict(zip((t.name for t in self.tenants), self.runner.quanta))

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def macro_step(self) -> None:
        for et in self.executor_tenants:
            self.runner.total_steps[et.name] = et.steps_done + self.quanta[et.name]
        self.runner.run()

    def alone(self, name: str) -> float:
        """Seconds of one quanta of tenant ``name`` alone on its stream,
        synchronised."""
        et = next(e for e in self.executor_tenants if e.name == name)
        q = self.quanta[name]
        self.sync()
        t0 = time.perf_counter()
        with torch.cuda.stream(et.stream) if et.stream is not None else contextlib.nullcontext():
            for _ in range(q):
                et.state = et.step_fn(et.state)
        self.sync()
        et.steps_done += q
        return time.perf_counter() - t0

    def counts(self) -> dict:
        return {t.name: t.steps for t in self.tenants}

    def work(self, before: dict, after: dict) -> tuple[float, float]:
        """Positions and model operations between two ``counts()``."""
        pos = ops = 0.0
        for t in self.tenants:
            for s in range(before[t.name], after[t.name]):
                pos += t.positions_step
                ops += t.flops_at(s)
        return pos, ops

    def release(self) -> None:
        """Free the program's state; the inputs, the samples and the served
        tokens stay for the check."""
        for t in self.tenants:
            t.release()
        for et in self.executor_tenants:
            et.state = None
        self.executor_tenants = self.runner = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def traced_part(cell: Cell, ctx: dict) -> None:
    """Profile a few co-run macro-steps, then run each tenant's quanta alone."""
    from torch.profiler import ProfilerActivity, profile

    cuda = cell.device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    before, l0 = cell.counts(), _launches()
    cell.sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(TRACED_MACRO_STEPS):
            cell.macro_step()
        cell.sync()
        wall = time.perf_counter() - t0
    path = ROOT / "build" / "portbench" / "trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    ctx["trace"] = Trace.from_profiler(prof, str(path), wall)
    after, l1 = cell.counts(), _launches()
    ctx["traced_steps"] = {t.name: range(before[t.name], after[t.name]) for t in cell.tenants}
    ctx["traced_launches"] = {k: l1[k] - l0[k] for k in l0}
    ctx["alone_s"] = {t.name: min(cell.alone(t.name) for _ in range(ALONE_ROUNDS))
                      for t in cell.tenants}


def reader(name: str):
    """The ``read`` of ``metrics/<name>.py``, found by the metric's whole name."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    if spec is None or not path.exists():
        raise SystemExit(f"portbench: no reader {path.relative_to(ROOT)} for metric {name!r}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(entries: list, ctx: dict) -> dict:
    out = {}
    for m in entries:
        v = reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def forbidden_modules() -> list[str]:
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def run(spec: dict, seed: int, seconds: float, trace: bool, device="cuda",
        control: bool = False, log=print, readings: str | None = None) -> dict:
    """One run; returns the result line's object (``correct`` decided)."""
    device = torch.device(device)
    c = spec["config"]
    cell = Cell(spec, seed, device)
    cell.macro_step()                                   # warm-up: every shape of the cell
    cell.sync()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    before = cell.counts()
    setup_s = process_age_s()
    t0 = time.perf_counter()
    n_macro = 0
    while True:
        cell.macro_step()
        n_macro += 1
        if time.perf_counter() - t0 >= seconds:
            break
    cell.sync()
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    positions, ops = cell.work(before, cell.counts())
    ctx = {"spec": spec, "config": c, "cell": cell, "window_s": window_s, "n_macro": n_macro,
           "positions": positions, "flops": ops, "peak_bytes": peak, "setup_s": setup_s,
           "quanta": cell.quanta, "device": device}
    log(f"portbench: window {window_s:.3f} s, {n_macro} macro-steps (quanta {cell.quanta}), "
        f"{positions:.0f} positions, {ops:.4e} model flops, peak {peak / 2**30:.2f} GiB, "
        f"set-up {setup_s:.2f} s")
    if trace:
        traced_part(cell, ctx)
    metrics = read_metrics(spec["per_layer"] if trace else spec["end_to_end"], ctx)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"metrics": metrics, "device": dev}
    if trace and "trace" in ctx:
        tr = ctx["trace"]
        dev["busy_s"], dev["window_s"] = tr.busy_s(), tr.wall_s
        result["breakdown"] = tr.breakdown()
    cell.release()
    t_check = time.perf_counter()
    prog, ctrl = check.check(cell.tenants, cell.weights, c, control=control)
    checks, attempted, failed = check.verdict(prog, spec["limits"])
    log(f"portbench: check took {time.perf_counter() - t_check:.1f} s")
    for who, r in (("program", prog), ("control", ctrl)):
        for name, line in (r.summary().items() if r is not None else ()):
            log(f"portbench: {who} {name}: {line}")
    if readings:
        Path(readings).write_text(json.dumps(
            {who: None if r is None else {"values": r.values, "rows": r.rows}
             for who, r in (("program", prog), ("control", ctrl))}))
    if ctrl is not None:
        cchecks, _, cfailed = check.verdict(ctrl, spec["limits"])
        result["control"] = {"checks": cchecks, "failed": cfailed}
    return {"correct": failed == 0, "attempted": attempted, "failed": failed, **result,
            "checks": checks}


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"power limit not read ({e})"
