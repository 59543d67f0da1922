"""The children of ``tests/test_torch_sharded_steps.py``: each of four gloo
processes on a (2, 2) CPU mesh runs the dense smoke config's train, prefill
and decode steps under every rule table, sharded and with ``mesh=None``,
and rank 0 writes what it saw to a JSON file.  Every rank joins every
collective (``full_tensor()`` included).  Importable, since ``tests/`` has
no ``__init__.py`` and spawned children import their target by name."""
import json

import torch
import torch.distributed as dist

RULES = ("baseline", "sp", "fsdp_sp")
B, S, DEC_STEPS = 4, 16, 4


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _leaves(tree):
    from repro_torch.optim import tree_leaves
    return tree_leaves(tree)


def _clone(tree):
    from repro_torch.optim import tree_map
    return tree_map(lambda t: t.clone(), tree)


def _groups(mesh) -> dict:
    return {mesh.get_group(n).group_name: n for n in mesh.mesh_dim_names}


def _collectives(counter, groups) -> list:
    return sorted({(name, groups.get(g, g)) for name, _, g in counter.collectives})


def run(rank: int, world: int, store_path: str, out_path: str) -> None:
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import RULESETS
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.roofline import CostCounter
    from repro_torch.models.model import init_params
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.runtime.steps import (
        full, make_decode_step, make_prefill_step, make_train_step,
    )

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)
    try:
        torch.manual_seed(0)
        mesh = make_test_mesh(2, 2, "cpu")
        groups = _groups(mesh)
        cfg = get_smoke_config("llama3-8b").replace(dtype="float32")
        g = torch.Generator().manual_seed(1)
        tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g, dtype=torch.int32)
        labels = torch.randint(-1, cfg.vocab_size, (B, S), generator=g, dtype=torch.int32)
        batch = {"tokens": tokens, "labels": labels}
        params0 = init_params(cfg, 0, "cpu")
        out = {}
        for name in RULES:
            rules = RULESETS[name]
            rec = out[name] = {}
            # train: one step from the same state, sharded and not
            ref_p, ref_o = _clone(params0), init_opt_state(_clone(params0))
            ref_p, ref_o, ref_m = make_train_step(cfg, OptConfig(), "cpu")(ref_p, ref_o, batch)
            step = make_train_step(cfg, OptConfig(), "cpu", mesh=mesh, rules=rules)
            dp, do = step.distribute(_clone(params0))
            with CostCounter() as c:
                dp, do, m = step(dp, do, batch)
            rec["train_loss"] = _rel(m["loss"], ref_m["loss"])
            rec["train_grad_norm"] = _rel(m["grad_norm"], ref_m["grad_norm"])
            rec["train_params"] = max(_rel(full(a), b) for a, b in zip(_leaves(dp), _leaves(ref_p)))
            rec["train_master"] = max(_rel(full(a), b) for a, b in
                                      zip(_leaves(do["master"]), _leaves(ref_o["master"])))
            rec["train_collectives"] = _collectives(c, groups)
            # prefill
            shape = ShapeConfig("t", S, B, "prefill")
            ref_l, ref_c = make_prefill_step(cfg, shape, "cpu")(params0, tokens)
            pf = make_prefill_step(cfg, shape, "cpu", mesh=mesh, rules=rules)
            dpar = pf.distribute(_clone(params0))
            with CostCounter() as c:
                lg, cache = pf(dpar, tokens)
            rec["prefill_logits"] = _rel(full(lg), ref_l)
            rec["prefill_cache"] = max(_rel(full(cache[k]), ref_c[k]) for k in ("k", "v"))
            rec["prefill_collectives"] = _collectives(c, groups)
            # decode: ragged positions against a fresh cache
            ref_dec = make_decode_step(cfg, B, S, "cpu")
            dec = make_decode_step(cfg, B, S, "cpu", mesh=mesh, rules=rules)
            rc, dc = ref_dec.init_cache(params0), dec.init_cache(dpar)
            errs = []
            with CostCounter() as c:
                for i in range(DEC_STEPS):
                    pos = torch.tensor([0, 3, 7, 11], dtype=torch.int32) + i
                    rl, rc = ref_dec(params0, rc, tokens[:, i], pos)
                    dl, dc = dec(dpar, dc, tokens[:, i], pos)
                    errs.append(_rel(full(dl), rl))
            rec["decode_logits"] = max(errs)
            rec["decode_cache"] = max(_rel(full(dc[k]), rc[k]) for k in ("k", "v"))
            rec["decode_collectives"] = _collectives(c, groups)
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()
