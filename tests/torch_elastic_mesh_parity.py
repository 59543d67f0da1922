"""The children of ``tests/test_torch_elastic_mesh.py``: four gloo processes
run ``ElasticTrainer`` over the sharded ``make_train_step`` of a dense
smoke config (llama3-8b's, f32) on a (4, 1) ``("data", "model")``
``DeviceMesh``, global batch 8 x 16, a checkpoint every 3 steps:

- ``whole``: 12 steps, no failure (the uninterrupted run);
- ``row1``: 12 steps, row 1 failing at step 7 (3 survivors, so 2 rows:
  ranks 0 and 2; rewound to 6);
- ``row0``: 6 steps, row 0 failing at step 4 (rows 1 and 2 survive; the
  checkpoint writer moves to rank 1; rewound to 3);
- ``crash``: 3 steps, then a second trainer on the same directory to 6.

Every rank records its log, its losses, who wrote which checkpoint, the
saved and restored leaves' equality and whether its data row's local batch
was its ``rebalance_bounds`` slice; rank 0 writes them all to a JSON file.
Importable, since ``tests/`` has no ``__init__.py`` and spawned children
import their target by name."""
import json
import os

import torch
import torch.distributed as dist

B, S, EVERY = 8, 16, 3
# case -> (steps, failures as (step, rows)); "crash" runs to 3, then to 6
CASES = {"whole": (12, []), "row1": (12, [(7, [1])]), "row0": (6, [(4, [0])]),
         "crash": (3, [])}
CRASH_RESUME_TO = 6


def config():
    from repro_torch.configs import get_smoke_config

    return get_smoke_config("llama3-8b").replace(dtype="float32")


def _trainer(ckpt_dir: str, rec: dict):
    """An ``ElasticTrainer`` over the sharded step that records into ``rec``."""
    from repro_torch.data import DataPipeline, batch_to_device
    from repro_torch.models.model import init_params
    from repro_torch.optim import OptConfig, tree_leaves
    from repro_torch.runtime import elastic as te
    from repro_torch.runtime.steps import batch_specs_like, full, make_train_step, shard

    cfg = config()
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=2)
    pipe = DataPipeline(cfg.vocab_size, S, B, seed=0)

    def make_step(mesh):
        step = make_train_step(cfg, opt_cfg, "cpu", mesh=mesh)
        tokens_sharding = batch_specs_like(cfg, mesh)[1]["tokens"]
        lo, hi = te.rebalance_bounds(B, mesh.size(0), mesh.get_local_rank("data"))

        def fn(state, batch):
            local = shard(batch["tokens"], tokens_sharding).to_local()
            rec["slices"].append(bool(torch.equal(local, batch["tokens"][lo:hi])))
            params, opt, metrics = step(state["params"], state["opt"], batch)
            rec["losses"].append(metrics["loss"].item())
            return {"params": params, "opt": opt}
        return fn

    def init_state(mesh):
        step = make_train_step(cfg, opt_cfg, "cpu", mesh=mesh)
        params, opt = step.distribute(init_params(cfg, 1, "cpu"))
        return {"params": params, "opt": opt}

    class Recording(te.ElasticTrainer):
        def _commit(self, step, state, mesh):
            rec["at"] = step
            super()._commit(step, state, mesh)

        def _dump(self, state):
            tree = te.ElasticTrainer._dump(state)
            rec["saved"][rec["at"]] = [t.clone() for t in tree_leaves(tree)]
            return tree

        def _load(self, template, tree, mesh):
            out = te.ElasticTrainer._load(template, tree, mesh)
            rec["restored"].append([full(t).detach().clone() for t in tree_leaves(out)])
            rec["restored_dtensors"] = sum(type(t).__name__ == "DTensor"
                                           for t in tree_leaves(out))
            return out

    def batch_fn(step, mesh):
        return batch_to_device(pipe.batch(step), "cpu")

    return Recording(make_step, init_state, ckpt_dir, ckpt_every=EVERY), batch_fn


def _equal(a: list, b: list) -> bool:
    return len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(x, y)
                                    for x, y in zip(a, b))


def _case(case: str, mesh, root: str, saves: list) -> dict:
    from repro_torch.runtime import elastic as te

    steps, events = CASES[case]
    rec = {"losses": [], "slices": [], "saved": {}, "restored": [], "at": None}
    saves.clear()
    tr, batch_fn = _trainer(os.path.join(root, case), rec)
    state, end = tr.run(mesh, steps, batch_fn,
                        failures=[te.FailureEvent(s, rows) for s, rows in events])
    out = {"log": list(tr.log), "left": state is None,
           "mesh": end.mesh.flatten().tolist(), "writer": te.checkpoint_writer(end),
           "losses": rec["losses"]}
    if case == "crash" and state is not None:
        first_saved, first_losses = rec["saved"], list(rec["losses"])
        rec.update(losses=[], saved={}, restored=[])
        tr, batch_fn = _trainer(os.path.join(root, case), rec)
        state, end = tr.run(mesh, CRASH_RESUME_TO, batch_fn)
        out.update(log=out["log"] + ["|"] + tr.log, losses=first_losses + ["|"] + rec["losses"])
        rec["saved"] = {**first_saved, **rec["saved"]}
    if rec["restored"]:
        rewound = steps if case == "crash" else int(
            next(e for e in out["log"] if e.startswith("shrunk")).split("@")[1])
        out["restored_equal"] = _equal(rec["restored"][0], rec["saved"][rewound])
        out["n_restored"] = len(rec["restored"])
        out["restored_leaves"] = len(rec["restored"][0])
        out["restored_dtensors"] = rec["restored_dtensors"]
        out["dtypes"] = sorted({str(t.dtype) for t in rec["saved"][rewound]})
    out.update(saves=list(saves), slices_ok=all(rec["slices"]), n_slices=len(rec["slices"]))
    return out


def run(rank: int, world: int, store_path: str, root: str, out_path: str) -> None:
    from repro_torch import checkpoint as ck
    from repro_torch.launch.mesh import make_test_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)
    saves = []
    save = ck.save

    def recording_save(ckpt_dir, step, tree, *a, **kw):     # who writes what
        saves.append([os.path.basename(ckpt_dir), step])
        return save(ckpt_dir, step, tree, *a, **kw)

    ck.save = recording_save
    try:
        torch.manual_seed(0)
        mesh = make_test_mesh(4, 1, "cpu")
        out = {}
        for case in CASES:
            out[case] = _case(case, mesh, root, saves)
            dist.barrier()          # the ranks a failure dropped wait here
        every = [None] * world
        dist.all_gather_object(every, out)
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(every, f)
    finally:
        ck.save = save
        dist.destroy_process_group()
