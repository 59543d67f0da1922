"""Training tenants of language models for the Level-2 executor.

Port of ``make_tiny_train_tenant`` in ``examples/co_schedule.py``: a
tenant whose step is ``runtime/steps.py: make_train_step``'s (the loss and
its gradients by autograd, the attention forward through the flash
kernel, its backward through ``flash_attention_bwd``, then AdamW with f32
master weights).  :func:`train_step` is that step's implementation,
re-exported here.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.data import DataPipeline, batch_to_device
from repro_torch.models.model import init_params
from repro_torch.optim import OptConfig, init_opt_state
from repro_torch.runtime.multitenant import Tenant
from repro_torch.runtime.steps import make_train_step, train_step

__all__ = ["make_train_tenant", "train_step"]


def make_train_tenant(name: str, cfg, share: float, seq: int, batch: int, *, seed: int,
                      device="cuda", stream: torch.cuda.Stream | None = None) -> Tenant:
    """A tenant that trains ``cfg`` on the fixed batch ``pipe.batch(0)`` of a
    markov ``DataPipeline``, with ``OptConfig(lr=1e-3, warmup_steps=5,
    decay_steps=1000)``, as ``examples/co_schedule.py`` step 4 does.

    Its state is ``(params, opt, log)``: ``log`` is a tuple of each step's
    metrics.  Weights and data come from ``seed``; the reference seeds both
    with ``hash(name) % 2**31``, which Python salts per process for a
    ``str``.  With ``stream``, the state is made on that stream.  Every
    family whose batch the pipeline makes trains (dense, moe, hybrid, vlm,
    ssm); an encoder-decoder (audio) config is refused, as the pipeline
    makes no ``frames`` (nor does the reference's)."""
    if cfg.enc_dec:
        raise NotImplementedError(f"{cfg.name}: the data pipeline makes no encoder frames")
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=5, decay_steps=1000)
    pipe = DataPipeline(cfg.vocab_size, seq, batch, seed=seed)
    on_stream = torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()
    with on_stream:
        params = init_params(cfg, seed, device)
        opt = init_opt_state(params)
        batch0 = batch_to_device(pipe.batch(0), device)

    train = make_train_step(cfg, opt_cfg, device)

    def step(state):
        params, opt, log = state
        params, opt, metrics = train(params, opt, batch0)
        return params, opt, log + (metrics,)

    return Tenant(name, step, (params, opt, ()), share, stream=stream)
