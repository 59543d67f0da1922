"""Training launcher: the train step, the data pipeline and checkpointed
resume, for any registry architecture whose batch the pipeline makes.

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m --scale full \\
        --batch 8 --seq 128 --steps 100 --ckpt-dir /tmp/ckpt --ckpt-every 50

Port of ``repro/launch/train.py`` on one device: ``OptConfig()``'s
defaults, ``init_params(cfg, 0)``, a markov ``DataPipeline`` from seed 0,
``make_train_step``, a resume from the latest committed checkpoint of
``--ckpt-dir``, ``{"params", "opt"}`` saved every ``--ckpt-every`` steps,
and the reference's lines.  The ``--mesh-*`` flags are not ported (one
device); ``--device`` is added, as ``launch/serve.py`` has it.

The reference's resume fails for a bf16 model: its ``restore`` gives a bf16
leaf back as a raw ``V2`` array, which ``jax.device_put`` refuses
(ROADMAP.md §3).  ``repro_torch.checkpoint.restore`` gives it back as
bf16, so this launcher resumes.  The audio family is refused up front: the
pipeline makes no ``frames`` (nor does the reference's, whose ``loss_fn``
then raises ``KeyError``).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import checkpoint as ck
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import DataPipeline, batch_to_device
from repro_torch.models.model import init_params
from repro_torch.optim import OptConfig, init_opt_state
from repro_torch.runtime.steps import make_train_step


def main(argv=None) -> dict | None:
    """Runs the training loop; returns the last step's metrics (None when
    the checkpoint is already at ``--steps``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--scale", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.scale == "full" else get_smoke_config(args.arch)
    if cfg.enc_dec:
        raise NotImplementedError(f"{cfg.name}: the data pipeline makes no encoder frames, and "
                                  "the reference's loss_fn needs them")
    device = torch.device(args.device)
    print(f"arch={cfg.name} device={device} batch={args.batch} seq={args.seq}")

    step_fn = make_train_step(cfg, OptConfig(), device)
    pipe = DataPipeline(cfg.vocab_size, args.seq, args.batch, seed=0, mode="markov")
    start = 0
    if args.ckpt_dir and ck.latest_step(args.ckpt_dir) is not None:
        tree, _, start = ck.restore(args.ckpt_dir, device=device)
        params, opt = tree["params"], tree["opt"]
        print(f"resumed @ {start}")
    else:
        params = init_params(cfg, 0, device)
        opt = init_opt_state(params)

    metrics = None
    t0 = time.time()
    for s in range(start, args.steps):
        batch = batch_to_device(pipe.batch(s), device)
        params, opt, metrics = step_fn(params, opt, batch)
        if s % 10 == 0 or s == args.steps - 1:
            print(f"step {s:4d} loss={float(metrics['loss']):.3f} "
                  f"({(s - start + 1) / (time.time() - t0):.2f} it/s)")
        if args.ckpt_dir and (s + 1) % args.ckpt_every == 0:
            ck.save(args.ckpt_dir, s + 1, {"params": params, "opt": opt})
    print("done")
    return metrics


if __name__ == "__main__":
    main()
