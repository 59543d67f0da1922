"""The children of ``tests/test_torch_vecsim_devices.py``: each of four gloo
processes builds the port's vectorized engines on the CPU and calls
``sweep(traces, devices=mesh)`` on a 1-D ``DeviceMesh`` of the four ranks
with the same traces, as every rank of a sharded sweep does.  Each rank
then runs a share of the cases unsharded; rank 0 compares every rank's
gathered lanes with those and writes what it saw to a JSON file.  Importable, since
``tests/`` has no ``__init__.py`` and spawned children import their target
by name."""
import json

import torch
import torch.distributed as dist

GOLDEN = "tests/golden/train_agent_proxy_v1.npz"
RTOL = 1e-6          # the reference's test_sweep_sharded_matches_unsharded
# case -> (engine, number of traces, with_metrics)
CASES = {
    "ts-8": ("ts", 8, False),
    "rl-8": ("rl", 8, False),
    "ts-metrics-8": ("ts", 8, True),
    "rl-metrics-8": ("rl", 8, True),
    "ts-7": ("ts", 7, False),          # 7 lanes do not divide over 4 ranks: unsharded
    "rl-7": ("rl", 7, False),
}


def traces(n: int, arrivals: int = 24) -> list:
    """The reference's test traces (``tests/test_vecsim.py:
    test_sweep_sharded_matches_unsharded``: diurnal, 24 arrivals at load
    1.2, seeds 0..n-1) from the port's zoo; the RL cases take 12
    arrivals."""
    from repro_torch import online as to
    from repro_torch.core import make_zoo

    zoo = make_zoo(dryrun_dir=None)
    return [to.TRACE_FAMILIES["diurnal"](zoo, n=arrivals, load=1.2, seed=s) for s in range(n)]


def case_traces(case: str) -> list:
    kind, n, _ = CASES[case]
    return traces(n, 24 if kind == "ts" else 12)


def engine(kind: str, telemetry: bool, device: str = "cpu"):
    from repro_torch import online as to
    from repro_torch.convert import GOLDEN_WINDOW, load_golden_dqn
    from repro_torch.core.env import EnvConfig
    from repro_torch.online import vecsim as tv

    if kind == "ts":
        return tv.VectorizedClusterSimulator(to.TimeSharingPolicy(), window=8, capacity=64,
                                             telemetry=telemetry, device=device)
    agent = load_golden_dqn(GOLDEN, "cpu")
    return tv.VectorizedClusterSimulator(
        to.RLDispatchPolicy(agent, EnvConfig(window=GOLDEN_WINDOW)), window=GOLDEN_WINDOW,
        capacity=64, telemetry=telemetry, device=device)


def fields(out, with_metrics: bool) -> dict:
    """A sweep's result as ``{name: tensor}`` (the summary's fields, then the
    metrics' under ``metrics.``)."""
    summ, ms = out if with_metrics else (out, None)
    d = dict(zip(summ._fields, summ))
    if ms is not None:
        d.update({f"metrics.{k}": v for k, v in zip(ms._fields, ms)})
    return d


def compare(got: dict, want: dict) -> dict:
    """Integer fields exactly, floats within ``RTOL``; shapes equal."""
    rec = {"same_fields": sorted(got) == sorted(want), "counts_equal": True,
           "floats_close": True, "bit_equal": True, "worst_float_rel": 0.0}
    for k, w in want.items():
        g = got[k]
        if g.shape != w.shape:
            rec["same_fields"] = False
            continue
        rec["bit_equal"] &= bool(torch.equal(g, w))
        if w.is_floating_point():
            rec["floats_close"] &= bool(torch.allclose(g, w, rtol=RTOL, atol=RTOL))
            rel = float(((g.double() - w.double()).abs() / w.double().abs().clamp_min(1e-30))
                        .max()) if w.numel() else 0.0
            rec["worst_float_rel"] = max(rec["worst_float_rel"], rel)
        else:
            rec["counts_equal"] &= bool(torch.equal(g, w))
    return rec


def refusals(mesh2d, mesh1d) -> dict:
    """The mesh form's refusals: a 2-D mesh, and an engine on another
    device than the rank's."""
    out = {}
    tr = traces(4)
    for name, eng, devices in (("2d_mesh", engine("ts", False), mesh2d),
                               ("engine_elsewhere", engine("ts", False, "meta"), mesh1d)):
        try:
            eng.sweep(tr, devices=devices)
            out[name] = "no error"
        except ValueError as e:
            out[name] = f"ValueError: {e}"
    return out


def run(rank: int, world: int, store_path: str, out_path: str) -> None:
    from torch.distributed.device_mesh import DeviceMesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)
    try:
        mesh = DeviceMesh("cpu", torch.arange(world), mesh_dim_names=("lanes",))
        mesh2d = DeviceMesh("cpu", torch.arange(world).reshape(2, world // 2),
                            mesh_dim_names=("data", "model"))
        engines = {(k, m): engine(k, m) for k in ("ts", "rl") for m in (False, True)}
        got, stored = {}, {}
        for case, (kind, n, metrics) in CASES.items():
            eng = engines[kind, metrics]
            out = eng.sweep(case_traces(case), devices=mesh, with_metrics=metrics)
            got[case] = fields(out, metrics)
            if metrics:     # the telemetry engine keeps the gathered metrics
                stored[case] = bool(all(torch.equal(a, b) for a, b in
                                        zip(eng.last_sweep_metrics, out[1])))
        # the unsharded sweeps, one case in ``world`` a rank
        want = {case: fields(engines[kind, metrics].sweep(case_traces(case),
                                                          with_metrics=metrics), metrics)
                for i, (case, (kind, _, metrics)) in enumerate(CASES.items())
                if i % world == rank}
        every = [None] * world
        dist.all_gather_object(every, {"got": got, "stored": stored, "want": want})
        if rank == 0:
            want = {k: v for r in every for k, v in r["want"].items()}
            res = {"refusals": refusals(mesh2d, mesh)}
            for case in CASES:
                res[case] = {"lanes": int(want[case]["makespan"].shape[0]),
                             "ranks": [compare(r["got"][case], want[case]) for r in every],
                             "stored": [r["stored"].get(case) for r in every]}
            with open(out_path, "w") as f:
                json.dump(res, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()
