"""Training tenants of language models for the Level-2 executor.

Port of ``make_tiny_train_tenant`` in ``examples/co_schedule.py`` and of the
train step of ``examples/train_lm.py``: the loss and its gradients by
autograd (the attention forward through the flash kernel, its backward
through ``flash_attention_bwd``), then AdamW with f32 master weights.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.data import DataPipeline, batch_to_device
from repro_torch.models.model import init_params, loss_fn
from repro_torch.optim import (
    OptConfig, adamw_update, init_opt_state, tree_leaves, tree_unflatten,
)
from repro_torch.runtime.multitenant import Tenant


def train_step(params, opt, batch, cfg, opt_cfg: OptConfig):
    """One step: ``(params, opt, metrics)``, params and optimizer state
    updated in place.  ``params``' leaves must have ``requires_grad``;
    ``metrics`` holds the loss's metrics, ``grad_norm`` and ``lr`` as 0-dim
    tensors (reading them waits for the device)."""
    leaves = tree_leaves(params)
    with torch.enable_grad():
        total, metrics = loss_fn(params, batch, cfg)
        grads = tree_unflatten(params, torch.autograd.grad(total, leaves))
    del total
    with torch.profiler.record_function("adamw"):
        params, opt, om = adamw_update(params, grads, opt, opt_cfg)
    return params, opt, {**metrics, **om}


def make_train_tenant(name: str, cfg, share: float, seq: int, batch: int, *, seed: int,
                      device="cuda", stream: torch.cuda.Stream | None = None) -> Tenant:
    """A tenant that trains ``cfg`` on the fixed batch ``pipe.batch(0)`` of a
    markov ``DataPipeline``, with ``OptConfig(lr=1e-3, warmup_steps=5,
    decay_steps=1000)``, as ``examples/co_schedule.py`` step 4 does.

    Its state is ``(params, opt, log)``: ``log`` is a tuple of each step's
    metrics.  Weights and data come from ``seed``; the reference seeds both
    with ``hash(name) % 2**31``, which Python salts per process for a
    ``str``.  With ``stream``, the state is made on that stream.  An
    encoder-decoder config is refused: the pipeline makes no ``frames``."""
    if cfg.enc_dec:
        raise NotImplementedError(f"{cfg.name}: the data pipeline makes no encoder frames")
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=5, decay_steps=1000)
    pipe = DataPipeline(cfg.vocab_size, seq, batch, seed=seed)
    on_stream = torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()
    with on_stream:
        params = init_params(cfg, seed, device)
        for p in tree_leaves(params):
            p.requires_grad_(True)
        opt = init_opt_state(params)
        batch0 = batch_to_device(pipe.batch(0), device)

    def step(state):
        params, opt, log = state
        params, opt, metrics = train_step(params, opt, batch0, cfg, opt_cfg)
        return params, opt, log + (metrics,)

    return Tenant(name, step, (params, opt, ()), share, stream=stream)
