"""Dry run: trace every (arch x shape x mesh) cell's step on a fake world.

Port of ``repro/launch/dryrun.py``.  The reference lowers and compiles each
cell's step for 512 placeholder host devices and reads the compiled
module's memory, cost and collectives.  Here each cell runs in a
:func:`~repro_torch.launch.mesh.fake_world` of 256 (pod) or 512
(multi-pod) ranks, under ``FakeTensorMode``: the step's DTensor program
runs as rank 0 would run it, on fake tensors (nothing is allocated and
nothing is sent), and a :class:`~repro_torch.launch.roofline.CostCounter`
reads rank 0's local ops.

Cost-extraction protocol, the reference's (three traces a cell):
  A. the full step -> memory (argument, temp, output, peak bytes), the
     trace's seconds, and every cost of the whole stack;
  B, C. the 2- and 1-scan-unit variants (:func:`with_scan_units`) ->
     ``total = C + (B - C) * (n_units - 1)`` for flops, bytes and
     collectives.
Eager torch sees every layer, so trace A's costs are exact and are
recorded beside the differenced ones (``flops_per_chip_full``, ...): they
check the reference's assumption that a layer costs the same at every
depth.  Multi-pod cells skip B and C (memory and success only), as the
reference's do.  Every family's cell runs (the sharded steps of
``runtime/steps.py``); a cell that fails is recorded with ``ok: false``
and its error.

Where the reference's cost analysis visits a ``lax.scan`` body once
(its lines 22-24: the sLSTM's per-token scan stays a scan in the unrolled
variants, so its records undercount that loop by the sequence length),
the port counts every trip: the sLSTM's token loop and the Mamba scan's
chunk loop run on rank 0's local shards in one ``local_map`` each, and on
fake tensors their first trip is traced and counted once a trip
(``launch/roofline.py: TracedLoop``: the flops and major bytes of the
loop, without some 0.3 ms of host time an op for 4096-32768 tokens).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape decode_32k --mesh pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out experiments/dryrun
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import time
import traceback

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor

from repro_torch.configs import all_cells, get_config, get_shape
from repro_torch.launch.mesh import fake_world, make_production_mesh, make_test_mesh
from repro_torch.launch.roofline import (
    HBM_BYTES, PEAK_FLOPS, CostCounter, model_bytes_min, model_flops, roofline_terms,
)
from repro_torch.models.layers import pdtype
from repro_torch.optim import OptConfig, tree_map
from repro_torch.runtime.steps import (
    batch_specs, cache_shardings, distribute, make_decode_step, make_prefill_step,
    make_train_step, state_shardings,
)
from repro_torch.sharding import FSDP_SP_RULES, SEQ_PARALLEL_RULES, specs_to_shardings

RULESETS = {"baseline": None, "sp": SEQ_PARALLEL_RULES, "fsdp_sp": FSDP_SP_RULES}


# ---------------------------------------------------------------------------
# Scan-unit helpers (cost extraction)
# ---------------------------------------------------------------------------

def scan_units(cfg) -> int:
    """Depth of the layer stack in repeating units."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    if cfg.family == "ssm":
        return cfg.n_layers // 2
    return cfg.n_layers  # dense/moe/vlm; enc-dec scales enc+dec together


def with_scan_units(cfg, u: int):
    """The cost-variant config with ``u`` scan units (the reference's
    unrolled variant and chunk lengths; the port's stacks are loops
    already)."""
    kw: dict = {"unroll_layers": True}
    if cfg.family == "hybrid":
        kw["n_layers"] = u * cfg.attn_every
    elif cfg.family == "ssm":
        kw["n_layers"] = u * 2
    else:
        kw["n_layers"] = u
        if cfg.enc_dec:
            kw["n_enc_layers"] = u
    if cfg.mamba is not None:
        kw["mamba"] = dataclasses.replace(cfg.mamba, chunk=4096)
    if cfg.xlstm is not None:
        kw["xlstm"] = dataclasses.replace(cfg.xlstm, chunk=512)
    return cfg.replace(**kw)


# ---------------------------------------------------------------------------
# Tracing
# ---------------------------------------------------------------------------

def _fake(tree, shardings, device):
    """An abstract tree (``meta`` tensors) as empty tensors on ``device``,
    laid out by ``shardings`` (a 0-dim leaf stays plain).  Call under
    ``FakeTensorMode``."""
    return distribute(tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device=device),
                               tree), shardings)


def input_specs(cfg, shape, mesh, rules=None, device="cpu"):
    """Every model input of a cell as DTensors of empty local shards, laid
    out as the step takes them.  Call under ``FakeTensorMode`` (no
    allocation)."""
    if shape.kind == "train":
        params, psh, opt, osh = state_shardings(cfg, mesh, rules)
        batch, bsh = batch_specs(cfg, shape, mesh, rules)
        return {"params": _fake(params, psh, device), "opt_state": _fake(opt, osh, device),
                "batch": _fake(batch, bsh, device)}
    params, psh, _, _ = state_shardings(cfg, mesh, rules, with_opt=False)
    out = {"params": _fake(params, psh, device)}
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "prefill":
        if cfg.enc_dec:
            Se = min(cfg.enc_len, S)
            ab = {"frames": torch.empty((B, Se, cfg.d_model), dtype=pdtype(cfg), device="meta"),
                  "enc_lens": torch.empty((B,), dtype=torch.int32, device="meta")}
            sh = specs_to_shardings({"frames": ("act_batch", None, None),
                                     "enc_lens": ("act_batch",)}, mesh, rules, ab)
        else:
            ab = {"tokens": torch.empty((B, S), dtype=torch.int32, device="meta")}
            sh = specs_to_shardings({"tokens": ("act_batch", None)}, mesh, rules, ab)
        return {**out, **_fake(ab, sh, device)}
    cache, csh = cache_shardings(cfg, mesh, B, S, rules)
    vec = {k: torch.empty((B,), dtype=torch.int32, device="meta") for k in ("token", "pos")}
    vsh = specs_to_shardings({k: ("act_batch",) for k in vec}, mesh, rules, vec)
    return {**out, "cache": _fake(cache, csh, device), **_fake(vec, vsh, device)}


def _step(cfg, shape, mesh, rules, device, specs):
    """``(fn, args)`` of a cell's step."""
    if shape.kind == "train":
        fn = make_train_step(cfg, OptConfig(), device, mesh=mesh, rules=rules)
        return fn, (specs["params"], specs["opt_state"], specs["batch"])
    if shape.kind == "prefill":
        fn = make_prefill_step(cfg, shape, device, mesh=mesh, rules=rules)
        if cfg.enc_dec:
            return fn, (specs["params"], specs["frames"], specs["enc_lens"])
        return fn, (specs["params"], specs["tokens"])
    fn = make_decode_step(cfg, shape.global_batch, shape.seq_len, device, mesh=mesh, rules=rules)
    return fn, (specs["params"], specs["cache"], specs["token"], specs["pos"])


def _locals(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _locals(v)
    else:
        yield tree.to_local() if isinstance(tree, DTensor) else tree


def trace_step(cfg, shape, mesh, rules=None, device="cpu") -> dict:
    """One trace of a cell's step on ``mesh`` (rank 0's view) under
    ``FakeTensorMode``: its costs (flops, bytes, raw bytes, collectives,
    the kernels' calls), memory and seconds."""
    with FakeTensorMode():
        t0 = time.perf_counter()
        specs = input_specs(cfg, shape, mesh, rules, device)
        fn, args = _step(cfg, shape, mesh, rules, device, specs)
        args_local = [t for a in args for t in _locals(a)]
        setup_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        with CostCounter(existing=args_local) as c:
            out = fn(*args)
            live = c.live
        trace_s = time.perf_counter() - t1
        del out
    coll = c.stats()
    return {
        "setup_s": setup_s, "trace_s": trace_s,
        "argument_bytes": sum(t.numel() * t.element_size() for t in args_local),
        "temp_bytes": c.peak, "output_bytes": live,
        "flops": c.flops, "bytes_fused": c.bytes, "bytes": c.bytes_raw,
        "coll_w": coll.bytes_weighted, "coll_raw": coll.bytes_raw, "coll_count": coll.count,
        "coll_by_op": coll.by_op, "kernels": c.kernels,
    }


def trace_cell(cfg, shape, mesh, rules=None, cost_extract: bool = True, device="cpu") -> dict:
    """A cell's record fields on ``mesh``: trace A (memory, and the full
    costs), then, with ``cost_extract``, traces B and C and the
    reference's differenced costs and roofline terms."""
    a = trace_step(cfg, shape, mesh, rules, device)
    rec = {"lower_s": a["setup_s"], "compile_s": a["trace_s"],
           "argument_bytes": a["argument_bytes"], "output_bytes": a["output_bytes"],
           "temp_bytes": a["temp_bytes"]}
    rec["peak_bytes"] = rec["argument_bytes"] + rec["temp_bytes"]
    rec["fits_hbm"] = bool(rec["peak_bytes"] < HBM_BYTES)
    rec["hbm_limit"] = HBM_BYTES
    if not cost_extract:
        return rec
    L = scan_units(cfg)
    c1 = trace_step(with_scan_units(cfg, 1), shape, mesh, rules, device)
    c2 = trace_step(with_scan_units(cfg, 2), shape, mesh, rules, device) if L > 1 else c1
    gc.collect()

    def lin(key):
        return c1[key] + (c2[key] - c1[key]) * (L - 1)

    flops, byts, coll_w = lin("flops"), lin("bytes_fused"), lin("coll_w")
    rec.update(
        scan_units=L,
        flops_per_chip=flops,
        bytes_per_chip=byts,
        bytes_per_chip_raw_cpu=lin("bytes"),
        coll_bytes_weighted=coll_w,
        coll_bytes_raw=lin("coll_raw"),
        coll_count_unit=c2["coll_count"] - c1["coll_count"],
        coll_by_op_u1=c1["coll_by_op"],
        coll_by_op_u2=c2["coll_by_op"],
        flops_per_chip_full=a["flops"],
        bytes_per_chip_full=a["bytes_fused"],
        coll_bytes_weighted_full=a["coll_w"],
        coll_count_full=a["coll_count"],
        coll_by_op_full=a["coll_by_op"],
        kernels_full=a["kernels"],
        trace_s_units=[c1["trace_s"], c2["trace_s"]],
    )
    rec.update(roofline_terms(flops, byts, coll_w))
    return rec


def run_cell(arch: str, shape_id: str, mesh_kind: str = "pod", rules_name: str = "baseline",
             verbose: bool = True, cfg_override=None, cost_extract: bool = True,
             test_mesh: tuple[int, int] | None = None) -> dict:
    """One cell's record, as the reference writes it.  ``test_mesh``
    (n_data, n_model) traces on that small mesh in place of the pod."""
    n = (test_mesh[0] * test_mesh[1] if test_mesh else 512 if mesh_kind == "multipod" else 256)
    rules = RULESETS[rules_name]
    cfg = cfg_override or get_config(arch)
    shape = get_shape(shape_id)
    rec = {"arch": arch, "shape": shape_id, "mesh": mesh_kind, "rules": rules_name,
           "chips": n, "kind": shape.kind, "ok": False}
    try:
        with fake_world(n):
            mesh = (make_test_mesh(*test_mesh, device_type="cpu") if test_mesh else
                    make_production_mesh(multi_pod=mesh_kind == "multipod", device_type="cpu"))
            rec.update(trace_cell(cfg, shape, mesh, rules, cost_extract))
        rec["ok"] = True
        if cost_extract:
            mf = model_flops(cfg, shape)
            flops = rec["flops_per_chip"]
            rec["model_flops_total"] = mf
            rec["model_flops_per_chip"] = mf / n
            rec["useful_flops_ratio"] = rec["model_flops_per_chip"] / flops if flops else 0.0
            rec["model_bytes_min_total"] = model_bytes_min(cfg, shape)
            rec["roofline_fraction"] = (
                (rec["model_flops_per_chip"] / PEAK_FLOPS) / rec["step_time_lb_s"]
                if rec["step_time_lb_s"] > 0 else 0.0)
        if verbose:
            _print(rec)
    except Exception as e:  # noqa: BLE001 — the sweep records a failing cell
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"== {arch} x {shape_id} x {mesh_kind} FAILED: {rec['error']}", flush=True)
    return rec


def _print(rec: dict) -> None:
    print(f"== {rec['arch']} x {rec['shape']} x {rec['mesh']} [{rec['rules']}] ==", flush=True)
    print(f"  memory: args={rec['argument_bytes'] / 1e9:.2f}GB "
          f"temp={rec['temp_bytes'] / 1e9:.2f}GB out={rec['output_bytes'] / 1e9:.2f}GB "
          f"fits16GiB={rec['fits_hbm']} (trace {rec['compile_s']:.2f}s)")
    if "flops_per_chip" not in rec:
        return
    print(f"  costs (differenced x{rec['scan_units']}): flops/chip={rec['flops_per_chip']:.4e} "
          f"(full trace {rec['flops_per_chip_full']:.4e}) bytes/chip={rec['bytes_per_chip']:.4e} "
          f"(raw {rec['bytes_per_chip_raw_cpu']:.4e})")
    print(f"  collectives: weighted={rec['coll_bytes_weighted'] / 1e9:.3f}GB "
          f"raw={rec['coll_bytes_raw'] / 1e9:.3f}GB count/unit={rec['coll_count_unit']}")
    print(f"  roofline: compute={rec['compute_term_s'] * 1e3:.3f}ms "
          f"memory={rec['memory_term_s'] * 1e3:.3f}ms "
          f"collective={rec['collective_term_s'] * 1e3:.3f}ms dominant={rec['dominant']} "
          f"useful_ratio={rec['useful_flops_ratio']:.3f} "
          f"roofline_frac={rec['roofline_fraction']:.3f}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "both"])
    ap.add_argument("--rules", default="baseline", choices=list(RULESETS))
    ap.add_argument("--all", action="store_true", help="sweep all runnable cells")
    ap.add_argument("--resume", action="store_true", help="skip cells with ok records")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]

    cells = []
    if args.all:
        for c in all_cells():
            if c.runnable:
                cells.append((c.arch, c.shape))
            else:
                print(f"SKIP {c.arch} x {c.shape}: {c.skip}")
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        cells.append((args.arch, args.shape))

    n_fail = 0
    for arch, shape_id in cells:
        for mesh_kind in meshes:
            tag = f"{arch}_{shape_id}_{mesh_kind}_{args.rules}".replace(".", "_").replace("/", "_")
            out_path = os.path.join(args.out, tag + ".json")
            if args.resume and os.path.exists(out_path):
                with open(out_path) as f:
                    if json.load(f).get("ok"):
                        continue
            rec = run_cell(arch, shape_id, mesh_kind, args.rules,
                           cost_extract=(mesh_kind == "pod"))
            with open(out_path, "w") as f:
                json.dump(rec, f, indent=1)
            n_fail += 0 if rec["ok"] else 1
    print(f"dry-run complete: {len(cells) * len(meshes) - n_fail} ok, {n_fail} failed")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
