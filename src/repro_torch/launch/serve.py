"""Serving launcher: batched KV-cache decode for a ported registry
architecture.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-moe-16b --batch 4 --gen 32

Port of ``repro/launch/serve.py``: seeded random weights, ``gen`` greedy
steps from token 0 over a ``gen + 1``-slot cache, and the reference's line
(tokens/s, ms a step; the first step included).  The audio family decodes
against the cross-attention K/V of ``enc_len`` zero frames, as the
reference's ``init_cache`` gives them.  ``--mesh-data`` x
``--mesh-model`` (1 x 1 by default) is the decode step's mesh, as in
``launch/train.py``: every family decodes through its sharded step (on
one device a 1 x 1 mesh; a larger mesh needs a ``torchrun`` world of its
size).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models.model import init_params
from repro_torch.launch.mesh import launcher_mesh
from repro_torch.runtime.steps import full, make_decode_step


def main(argv=None) -> torch.Tensor:
    """Runs the decode loop and returns the last step's logits."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--scale", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.scale == "full" else get_smoke_config(args.arch)
    device = torch.device(args.device)
    with launcher_mesh(args.mesh_data, args.mesh_model, device) as mesh:
        return _serve(args, cfg, device, mesh)


def _serve(args, cfg, device, mesh):
    step = make_decode_step(cfg, args.batch, args.gen + 1, device=device, mesh=mesh)
    params = step.distribute(init_params(cfg, seed=0, device=device))
    cache = step.init_cache(params)

    tok = torch.zeros((args.batch,), dtype=torch.int32, device=device)
    t0 = time.perf_counter()
    for i in range(args.gen):
        pos = torch.full((args.batch,), i, dtype=torch.int32, device=device)
        logits, cache = step(params, cache, tok, pos)
        tok = full(logits).argmax(dim=-1).to(torch.int32)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    print(f"decoded {args.gen} steps x {args.batch} seqs: "
          f"{args.gen * args.batch / dt:.1f} tok/s ({dt / args.gen * 1e3:.1f} ms/step)")
    return full(logits)


if __name__ == "__main__":
    main()
