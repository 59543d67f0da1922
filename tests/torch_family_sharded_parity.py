"""The children of ``tests/test_torch_family_sharded_steps.py``: each of
four gloo processes on a (2, 2) CPU mesh runs the train, prefill and decode
steps of every non-dense family's smoke config in f32 (and chameleon's
under ``SEQ_PARALLEL_RULES``, deepseek-moe's at 16 routed experts, which
the rules shard on "model", and a dense config with 5 q heads, which the
model axis does not divide), sharded and with ``mesh=None``, and rank 0
writes what it saw to a JSON file.  Every rank joins every collective
(``full_tensor()`` included).  Importable, since ``tests/`` has no
``__init__.py`` and spawned children import their target by name."""
import dataclasses
import json

import torch
import torch.distributed as dist

from torch_sharded_parity import _clone, _collectives, _groups, _leaves, _rel

# case -> (arch, rules, config fields replaced)
CASES = {
    "qwen2-moe": ("qwen2-moe-a2.7b", "baseline", {}),
    "deepseek-moe": ("deepseek-moe-16b", "baseline", {}),
    "deepseek-moe-ep16": ("deepseek-moe-16b", "baseline", {"n_routed": 16}),
    "jamba": ("jamba-v0.1-52b", "baseline", {}),
    "xlstm": ("xlstm-125m", "baseline", {}),
    "chameleon": ("chameleon-34b", "baseline", {}),
    "chameleon-sp": ("chameleon-34b", "sp", {}),
    "seamless": ("seamless-m4t-large-v2", "baseline", {}),
    # q heads that the model axis does not divide, as qwen2.5-14b's 40 on 16
    "qwen2.5-5-heads": ("qwen2.5-14b", "baseline", {"n_heads": 5, "n_kv_heads": 1}),
}
B, S, DEC_STEPS = 4, 16, 4
ENC_LENS = (16, 11, 6, 13)


def config(case: str):
    from repro_torch.configs import get_smoke_config

    arch, _, fields = CASES[case]
    cfg = get_smoke_config(arch).replace(dtype="float32")
    if "n_routed" in fields:
        return cfg.replace(moe=dataclasses.replace(cfg.moe, n_routed=fields["n_routed"]))
    return cfg.replace(**fields)


def _max_rel(got: dict, want: dict) -> float:
    """The worst leaf's relative error."""
    return max(_rel(a, b) for a, b in zip(_leaves(got), _leaves(want)))


def _tree_rel(got: dict, want: dict) -> float:
    """The relative error of the whole tree as one vector."""
    pairs = [(a.double(), b.double()) for a, b in zip(_leaves(got), _leaves(want))]
    num = sum(float((a - b).square().sum()) for a, b in pairs)
    den = sum(float(b.square().sum()) for _, b in pairs)
    return (num / den) ** 0.5


def step_outputs(cfg, mesh, rules=None, groups=None) -> dict:
    """One train step, a prefill and four decode steps on the CPU, with
    ``mesh`` or without, from the same weights and inputs: by step, its
    outputs as full tensors (``"train"``: metrics, params, opt; ``"prefill"``:
    logits (None for the audio family's encoder pass), cache; ``"decode"``:
    each step's logits, the cache after them) and, with ``groups``, the
    collectives it issued by mesh dim."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.roofline import CostCounter
    from repro_torch.models.model import init_params
    from repro_torch.optim import OptConfig, init_opt_state, tree_map
    from repro_torch.runtime.steps import (
        full, make_decode_step, make_prefill_step, make_train_step,
    )

    def whole(tree):     # a copy: decode writes its cache in place
        return tree_map(lambda t: full(t).detach().clone(), tree)

    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g, dtype=torch.int32)
    labels = torch.randint(-1, cfg.vocab_size, (B, S), generator=g, dtype=torch.int32)
    batch = {"tokens": tokens, "labels": labels}
    if cfg.enc_dec:
        batch["frames"] = torch.randn((B, min(cfg.enc_len, S), cfg.d_model), generator=g)
    params0 = init_params(cfg, 0, "cpu")
    out, counters = {}, {}

    train = make_train_step(cfg, OptConfig(), "cpu", mesh=mesh, rules=rules)
    if mesh is None:
        p, o = _clone(params0), init_opt_state(_clone(params0))
    else:
        p, o = train.distribute(_clone(params0))
    with CostCounter() as counters["train"]:
        p, o, m = train(p, o, batch)
    out["train"] = {"metrics": m, "params": whole(p), "opt": whole(o)}

    pf = make_prefill_step(cfg, ShapeConfig("t", S, B, "prefill"), "cpu", mesh=mesh,
                           rules=rules)
    params = params0 if mesh is None else pf.distribute(_clone(params0))
    logits = None
    with CostCounter() as counters["prefill"]:
        if cfg.enc_dec:
            cache = pf(params, batch["frames"], torch.tensor(ENC_LENS, dtype=torch.int32))
        else:
            logits, cache = pf(params, tokens)
    out["prefill"] = {"logits": None if logits is None else full(logits), "cache": whole(cache)}

    # ragged positions; the audio family against its prefill cache
    dec = make_decode_step(cfg, B, S, "cpu", mesh=mesh, rules=rules)
    cache = cache if cfg.enc_dec else dec.init_cache(params)
    steps = []
    with CostCounter() as counters["decode"]:
        for i in range(DEC_STEPS):
            logits, cache = dec(params, cache, tokens[:, i],
                                torch.tensor([0, 3, 7, 11], dtype=torch.int32) + i)
            steps.append(full(logits))
    out["decode"] = {"logits": steps, "cache": whole(cache)}
    if groups is not None:
        for k, c in counters.items():
            out[k]["collectives"] = _collectives(c, groups)
    return out


def flat(out: dict) -> list:
    """Every tensor of a :func:`step_outputs` result, in a fixed order."""
    t, p = out["train"], out["prefill"]
    tensors = [t["metrics"][k] for k in sorted(t["metrics"])] + _leaves(t["params"]) + _leaves(
        {k: v for k, v in t["opt"].items() if k != "count"})
    if p["logits"] is not None:
        tensors.append(p["logits"])
    return tensors + _leaves(p["cache"]) + out["decode"]["logits"] + _leaves(
        out["decode"]["cache"])


def _case(cfg, rules, mesh, groups) -> dict:
    """The sharded steps' errors against the unsharded ones, and their
    collectives."""
    want, got = step_outputs(cfg, None), step_outputs(cfg, mesh, rules, groups)
    wm, gm = want["train"]["metrics"], got["train"]["metrics"]
    wo, go = want["train"]["opt"], got["train"]["opt"]
    rec = {f"{k}_collectives": got[k]["collectives"] for k in got}
    rec["train_loss"] = _rel(gm["loss"], wm["loss"])
    rec["train_grad_norm"] = _rel(gm["grad_norm"], wm["grad_norm"])
    rec["train_aux"] = max(_rel(gm[k], wm[k]) for k in ("moe_aux", "z_loss"))
    rec["train_drop_frac_equal"] = bool(gm["moe_drop_frac"] == wm["moe_drop_frac"])
    rec["train_moments"] = max(_max_rel(go[k], wo[k]) for k in ("m", "v"))
    rec["train_params"] = _tree_rel(got["train"]["params"], want["train"]["params"])
    rec["train_master"] = _tree_rel(go["master"], wo["master"])
    rec["train_params_worst_leaf"] = _max_rel(got["train"]["params"], want["train"]["params"])
    lw, lg = want["prefill"]["logits"], got["prefill"]["logits"]
    rec["prefill_logits"] = 0.0 if lw is None else _rel(lg, lw)
    rec["prefill_cache"] = _max_rel(got["prefill"]["cache"], want["prefill"]["cache"])
    rec["decode_logits"] = max(_rel(a, b) for a, b in zip(got["decode"]["logits"],
                                                          want["decode"]["logits"]))
    rec["decode_cache"] = _max_rel(got["decode"]["cache"], want["decode"]["cache"])
    return rec


def run(rank: int, world: int, store_path: str, out_path: str) -> None:
    from repro_torch.launch.dryrun import RULESETS
    from repro_torch.launch.mesh import make_test_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)
    try:
        torch.manual_seed(0)
        mesh = make_test_mesh(2, 2, "cpu")
        groups = _groups(mesh)
        out = {case: _case(config(case), RULESETS[CASES[case][1]], mesh, groups)
               for case in CASES}
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()
