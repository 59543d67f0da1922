"""Training launcher: the train step, the data pipeline and checkpointed
resume, for any registry architecture whose batch the pipeline makes.

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m --scale full \\
        --batch 8 --seq 128 --steps 100 --ckpt-dir /tmp/ckpt --ckpt-every 50

Port of ``repro/launch/train.py``: ``OptConfig()``'s defaults,
``init_params(cfg, 0)``, a markov ``DataPipeline`` from seed 0,
``make_train_step``, a resume from the latest committed checkpoint of
``--ckpt-dir``, ``{"params", "opt"}`` saved every ``--ckpt-every`` steps
(full tensors), and the reference's lines; ``--device`` is added, as
``launch/serve.py`` has it.  ``--mesh-data`` x ``--mesh-model`` (1 x 1 by
default) is the step's mesh (``launch/mesh.py: launcher_mesh``): every
family trains through its sharded step, on one device a 1 x 1 mesh; a
larger mesh needs a world of its size (``torchrun``), and the launcher
raises without one.

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
from repro_torch.launch.mesh import launcher_mesh
from repro_torch.optim import OptConfig, tree_map
from repro_torch.runtime.steps import full, make_train_step


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
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.scale == "full" else get_smoke_config(args.arch)
    if cfg.enc_dec:
        raise NotImplementedError(f"{cfg.name}: the data pipeline makes no encoder frames, and "
                                  "the reference's loss_fn needs them")
    device = torch.device(args.device)
    with launcher_mesh(args.mesh_data, args.mesh_model, device) as mesh:
        return _train(args, cfg, device, mesh)


def _train(args, cfg, device, mesh):
    print(f"arch={cfg.name} device={device} mesh={args.mesh_data}x{args.mesh_model} "
          f"batch={args.batch} seq={args.seq}")

    step_fn = make_train_step(cfg, OptConfig(), device, mesh=mesh)
    pipe = DataPipeline(cfg.vocab_size, args.seq, args.batch, seed=0, mode="markov")
    start = 0
    if args.ckpt_dir and ck.latest_step(args.ckpt_dir) is not None:
        tree, _, start = ck.restore(args.ckpt_dir, device=device)
        params, opt = tree["params"], tree["opt"]
        print(f"resumed @ {start}")
    else:
        params, opt = init_params(cfg, 0, device), None
    params, opt = step_fn.distribute(params, opt)

    metrics = None
    t0 = time.time()
    for s in range(start, args.steps):
        batch = batch_to_device(pipe.batch(s), device)
        params, opt, metrics = step_fn(params, opt, batch)
        if s % 10 == 0 or s == args.steps - 1:
            print(f"step {s:4d} loss={float(metrics['loss']):.3f} "
                  f"({(s - start + 1) / (time.time() - t0):.2f} it/s)")
        if args.ckpt_dir and (s + 1) % args.ckpt_every == 0:
            ck.save(args.ckpt_dir, s + 1, tree_map(full, {"params": params, "opt": opt}))
    print("done")
    return metrics


if __name__ == "__main__":
    main()
