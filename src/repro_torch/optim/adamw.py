"""AdamW with f32 master weights, global-norm clipping, warmup+cosine LR.

Port of ``repro/optim/adamw.py``.  Parameters and optimizer state are
nested dicts of tensors with the same keys.  The update runs leaf by leaf,
in place, under ``torch.no_grad()``: one f32 copy of the leaf's gradient,
then one fused pass (``torch._fused_adamw_``) over its master, moments and
that copy, then the master rounded into the parameter.  At llama3-8b width
the embedding alone holds 525M entries; the temporaries stay one leaf
large.  The step count, the clip scale and the learning rate stay 0-dim
f32 tensors on the parameters' device, so a step never waits for the host.

DTensor leaves (a sharded train step): each gradient is first
redistributed to its parameter's placements (the FSDP gradient
reduce-scatter, or the all-reduce of a replicated leaf's ``Partial``
sum), the global norm adds each leaf's local sum of squares over the
shards (one rank sums exactly as one device does), and the fused pass runs on
each rank's local shards; the optimizer state has the parameters'
placements.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def tree_leaves(tree: dict) -> list:
    """The leaves of a nested dict in the reference's tree order (sorted keys)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(tree_leaves(v) if isinstance(v, dict) else [v])
    return out


def tree_unflatten(tree: dict, leaves) -> dict:
    """A nested dict of ``tree``'s keys holding ``leaves`` in :func:`tree_leaves`'s order."""
    it = iter(leaves)

    def build(t):
        return {k: build(t[k]) if isinstance(t[k], dict) else next(it) for k in sorted(t)}

    return build(tree)


def tree_map(fn, tree: dict, *rest: dict) -> dict:
    """``fn`` applied leaf by leaf to trees of the same keys."""
    return {k: tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


def lr_at(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_frac``; f32 as in the reference."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * step / max(1, cfg.warmup_steps)
    prog = torch.clamp((step - cfg.warmup_steps) / max(1, cfg.decay_steps - cfg.warmup_steps),
                       0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def init_opt_state(params: dict) -> dict:
    """f32 master copies of the parameters, zero f32 moments and a zero step count."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)

    device = tree_leaves(params)[0].device
    return {
        "master": tree_map(lambda p: p.detach().to(torch.float32, copy=True), params),
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def _as_param(g, p):
    """A DTensor gradient in its parameter's placements."""
    return g.redistribute(p.device_mesh, p.placements) if isinstance(g, DTensor) else g


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _square_norm(g) -> torch.Tensor:
    """``||g||^2`` in f32; of a DTensor, the local shards' sums added over
    the mesh dims that shard it (a replicated dim is counted once)."""
    sq = torch.linalg.vector_norm(_local(g), dtype=torch.float32).square()
    if isinstance(g, DTensor):
        pl = [Partial() if p.is_shard() else Replicate() for p in g.placements]
        sq = DTensor.from_local(sq, g.device_mesh, pl).full_tensor()
    return sq


@torch.no_grad()
def global_norm(tree: dict) -> torch.Tensor:
    total = 0
    for g in tree_leaves(tree):
        total = total + _square_norm(g)
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: dict, cfg: OptConfig):
    """Returns ``(params, state, metrics)``; params keep their dtype.

    ``params`` and the state's ``master``, ``m`` and ``v`` are updated in
    place and returned; ``count`` is a new tensor.  ``metrics`` holds
    ``grad_norm`` and ``lr`` as 0-dim tensors.

    The fused pass computes the reference's update in another rounding
    order: it divides the gradient by ``1 / scale`` where the reference
    multiplies by the clip scale, applies the decay as
    ``master * (1 - lr * wd)`` before the Adam step, and forms the bias
    corrections from the f32 step count in double precision."""
    count = state["count"] + 1
    grads = tree_map(_as_param, grads, params)
    gnorm = global_norm(grads)
    inv_scale = torch.clamp((gnorm + 1e-9) / cfg.clip_norm, min=1.0)   # 1 / clip scale
    lr = lr_at(cfg, count)
    step = count.to(torch.float32)

    def upd(p, g, master, m, v):
        p, g, master, m, v = (_local(t) for t in (p, g, master, m, v))
        g32 = g.to(torch.float32, copy=True)                # the pass divides it in place
        torch._fused_adamw_(
            [master], [g32], [m], [v], [], [step], lr=lr, beta1=cfg.b1, beta2=cfg.b2,
            weight_decay=cfg.weight_decay if master.ndim >= 2 else 0.0,   # not norms/biases
            eps=cfg.eps, amsgrad=False, maximize=False, grad_scale=inv_scale, found_inf=None)
        p.copy_(master)

    tree_map(upd, params, grads, state["master"], state["m"], state["v"])
    new_state = {"master": state["master"], "m": state["m"], "v": state["v"], "count": count}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
