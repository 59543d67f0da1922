#!/usr/bin/env python3
"""Train chameleon-34b, cut to size, in both packages on the CPU, and print
their loss trajectories side by side.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/loss_swing.py [--d-model 1024]

Does the reference's loss swing at the train tenant's learning rate (lr
1e-3, warm-up 5, ``chip_smoke.py``'s ``LM_TRAIN_OPT``) as the port's does
on the card (chameleon-34b at 2 of 48 layers, phase 10 (c))?  Both
packages take the same weights (the reference's ``init_params`` from
``PRNGKey(0)``, carried over by ``repro_torch.convert``), the same markov
batch from their own ``DataPipeline`` (checked equal; one fixed batch, the
pipeline's step 0, as phase 10 (c) trains, or ``--per-step`` for the
pipeline's batch of each step), and step through their own train step:
the reference's jitted ``repro.runtime.steps.make_train_step`` on a 1 x 1
mesh, the port's
``make_train_step`` on the CPU.  The config keeps chameleon-34b's head
size (128), its 8:1 grouped heads, the QK-norm of the vlm family, its
vocab (65,536), bf16 and block remat; the width, the MLP and the depth
are cut (``--d-model``, ``--layers``) and the sequence is ``--seq``.
Prints each step's loss, grad norm and the two packages' relative
difference; the sizes used head the table.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

KW = dict(lr=1e-3, warmup_steps=5, decay_steps=1000)     # chip_smoke.py LM_TRAIN_OPT


def configs(d_model: int, layers: int):
    """chameleon-34b in both packages, cut to ``d_model`` (heads of 128,
    8 q heads a kv head, the MLP scaled with the width) and ``layers``."""
    from repro.configs import get_config as j_get
    from repro_torch.configs import get_config as t_get

    out = []
    for get in (j_get, t_get):
        full = get("chameleon-34b")
        heads = d_model // full.d_head
        out.append(full.replace(
            d_model=d_model, n_heads=heads, n_kv_heads=max(1, heads * full.n_kv_heads
                                                         // full.n_heads),
            d_ff=full.d_ff * d_model // full.d_model, n_layers=layers))
    return tuple(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--d-model", type=int, default=1024)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--seed", type=int, default=51)       # chip_smoke.py FAMILY_TRAIN_SEED
    ap.add_argument("--per-step", action="store_true",
                    help="the pipeline's batch of each step, not step 0's every step")
    args = ap.parse_args(argv)

    import jax
    import torch
    from jax.sharding import Mesh

    from repro.data import DataPipeline as JPipe
    from repro.models import model as jm
    from repro.optim import OptConfig as JOpt, init_opt_state as j_init
    from repro.runtime.steps import make_train_step as j_make
    from repro_torch.convert import model_params_from_jax, opt_state_from_jax
    from repro_torch.data import DataPipeline as TPipe
    from repro_torch.models.model import count_params_analytic
    from repro_torch.optim import OptConfig as TOpt
    from repro_torch.runtime.steps import make_train_step as t_make

    jcfg, tcfg = configs(args.d_model, args.layers)
    print(f"{tcfg.name} cut: d_model {tcfg.d_model}, {tcfg.n_heads}/{tcfg.n_kv_heads} heads of "
          f"{tcfg.d_head}, d_ff {tcfg.d_ff}, {tcfg.n_layers} layers, vocab {tcfg.vocab_size}, "
          f"{tcfg.dtype}, family {tcfg.family} (QK-norm), remat {tcfg.remat}; "
          f"{count_params_analytic(tcfg) / 1e6:.1f} M params; {args.batch} x {args.seq} markov "
          f"tokens (seed {args.seed}, {'a batch a step' if args.per_step else 'one fixed batch'}); "
          f"lr {KW['lr']}, warm-up {KW['warmup_steps']}; "
          f"jax {jax.__version__}, torch {torch.__version__}, on the CPU", flush=True)
    t0 = time.perf_counter()
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0))
    js = j_init(jp)
    params = model_params_from_jax(jax.device_get(jp), tcfg, "cpu")
    opt = opt_state_from_jax(jax.device_get(js), tcfg, "cpu")
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    j_step = j_make(jcfg, JOpt(**KW), mesh, donate=False)
    t_step = t_make(tcfg, TOpt(**KW), device="cpu")
    jpipe, tpipe = (P(tcfg.vocab_size, args.seq, args.batch, seed=args.seed)
                    for P in (JPipe, TPipe))
    print(f"weights carried over in {time.perf_counter() - t0:.1f} s", flush=True)
    print("step | reference loss | port loss | rel. diff | reference grad norm | port grad norm "
          "| seconds (ref, port)")
    for i in range(args.steps):
        jb = jpipe.batch(i if args.per_step else 0)
        tb = tpipe.batch(i if args.per_step else 0)
        if any(not np.array_equal(np.asarray(jb[k]), tb[k]) for k in jb):
            raise SystemExit(f"step {i}: the two pipelines' batches differ")
        t1 = time.perf_counter()
        jp, js, jm_ = j_step(jp, js, jb)
        jl, jg = float(jm_["loss"]), float(jm_["grad_norm"])
        t2 = time.perf_counter()
        params, opt, tm_ = t_step(params, opt, {k: torch.from_numpy(v) for k, v in tb.items()})
        tl, tg = tm_["loss"].item(), tm_["grad_norm"].item()
        t3 = time.perf_counter()
        print(f"{i + 1} | {jl:.6f} | {tl:.6f} | {abs(tl - jl) / abs(jl):.2e} | {jg:.6f} | "
              f"{tg:.6f} | {t2 - t1:.1f}, {t3 - t2:.1f}", flush=True)


if __name__ == "__main__":
    main()
