"""Train and serve step factories on one device.

Port of ``repro/runtime/steps.py``.  The reference jits each step with the
``NamedSharding`` trees of a mesh and donates the state: the train step
its params and optimizer state, the decode step its cache.  Here a step is
a callable on one device, and the donation is the in-place update (AdamW
writes the params, master weights and moments in place; decode writes its
cache row in place).  There are no meshes or shardings (multi-GPU is out
of scope), so ``state_shardings``, ``train_input_specs``,
``batch_specs_like`` and ``cache_shardings`` are not ported, and
:func:`abstract_state` and :func:`batch_specs` give the abstract trees
alone, as tensors on the ``meta`` device (shapes and dtypes, nothing
allocated).

- :func:`make_train_step`: ``loss_fn``'s value and gradients by autograd,
  then ``adamw_update``; one step of every family (the audio family's
  batch adds ``frames``).
- :func:`make_prefill_step`, :func:`make_decode_step`: over
  :func:`repro_torch.models.model.prefill` and ``decode_step``; the
  encoder-decoder's prefill step is the encoder pass and the
  cross-attention K/V.
"""
from __future__ import annotations

import torch

from repro_torch.models import encdec
from repro_torch.models.layers import pdtype, rmsnorm
from repro_torch.models.model import (
    decode_step, init_cache, init_params, loss_fn, prefill, require_ported,
)
from repro_torch.optim import (
    OptConfig, adamw_update, init_opt_state, tree_leaves, tree_unflatten,
)


def _check(what: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if tuple(t.shape) != shape or t.device.type != device.type:
        raise ValueError(f"{what}: got {tuple(t.shape)} on {t.device}, the step takes {shape} "
                         f"on {device}")


# ---------------------------------------------------------------------------
# Abstract state and the train step
# ---------------------------------------------------------------------------

def abstract_state(cfg, with_opt: bool = True):
    """``(params, opt_state)`` as ``meta`` tensors of the shapes and dtypes
    ``init_params`` and ``init_opt_state`` give (the reference's
    ``eval_shape``); ``opt_state`` is None without ``with_opt``."""
    params = init_params(cfg, device="meta")
    return params, (init_opt_state(params) if with_opt else None)


def batch_specs(cfg, shape) -> dict:
    """The abstract training batch of a ``ShapeConfig``, as ``meta``
    tensors: ``tokens`` and ``labels`` (B, S) int32; the audio family adds
    ``frames`` (B, min(enc_len, S), d_model) in the model's dtype."""
    B, S = shape.global_batch, shape.seq_len
    batch = {k: torch.empty((B, S), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    if cfg.enc_dec:
        batch["frames"] = torch.empty((B, min(cfg.enc_len, S), cfg.d_model), dtype=pdtype(cfg),
                                      device="meta")
    return batch


def train_step(params, opt, batch, cfg, opt_cfg: OptConfig):
    """One step: ``(params, opt, metrics)``, params and optimizer state
    updated in place.  ``params``' leaves are set to require grad;
    ``metrics`` holds the loss's metrics, ``grad_norm`` and ``lr`` as 0-dim
    tensors (reading them waits for the device)."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    with torch.enable_grad():
        total, metrics = loss_fn(params, batch, cfg)
        grads = tree_unflatten(params, torch.autograd.grad(total, leaves))
    del total
    with torch.profiler.record_function("adamw"):
        params, opt, om = adamw_update(params, grads, opt, opt_cfg)
    return params, opt, {**metrics, **om}


def make_train_step(cfg, opt_cfg: OptConfig, device="cuda"):
    """``step(params, opt, batch) -> (params, opt, metrics)``: :func:`train_step`
    on ``device`` for any batch size and length; ``batch`` holds ``tokens``
    and ``labels`` (B, S) and, for the audio family, ``frames`` (B, Se,
    d_model).  ``params`` and ``opt`` are updated in place (the
    reference donates them)."""
    require_ported(cfg)
    device = torch.device(device)

    def step(params, opt, batch):
        tokens = batch["tokens"]
        shape = (tokens.shape[0], tokens.shape[-1])                 # (B, S)
        _check("tokens", tokens, shape, device)
        _check("labels", batch["labels"], shape, device)
        if cfg.enc_dec:
            frames = batch["frames"]
            _check("frames", frames, (shape[0], *frames.shape[1:2], cfg.d_model), device)
        return train_step(params, opt, batch, cfg, opt_cfg)

    return step


# ---------------------------------------------------------------------------
# Serve steps
# ---------------------------------------------------------------------------

def make_decode_step(cfg, batch: int, max_len: int, device="cuda"):
    """``step(params, cache, token, pos) -> (logits (B, V) f32, cache)`` for
    ``batch`` sequences against a ``max_len``-slot cache (``step.init_cache
    (params)`` makes one); the cache is updated in place."""
    require_ported(cfg)
    device = torch.device(device)

    def step(params, cache, token, pos):
        _check("token", token, (batch,), device)
        _check("pos", pos, (batch,), device)
        return decode_step(params, cache, token, pos, cfg)

    step.init_cache = lambda params: init_cache(params, cfg, batch, max_len)
    return step


def make_prefill_step(cfg, shape, device="cuda"):
    """``step(params, tokens) -> (last logits (B, V) f32, cache)`` for a
    ``ShapeConfig``'s (global_batch, seq_len) tokens.

    For the audio family, ``step(params, frames, enc_lens) -> cache``:
    frames (B, Se, M) and enc_lens (B,) int32; the encoder pass, its
    ``enc_norm``, then a cache of ``seq_len`` self-attention slots with the
    cross-attention K/V of the encoder's output."""
    require_ported(cfg)
    device = torch.device(device)
    B, S = shape.global_batch, shape.seq_len

    if cfg.enc_dec:
        @torch.no_grad()
        def encode(params, frames, enc_lens):
            _check("frames", frames, (B, *frames.shape[1:2], cfg.d_model), device)
            _check("enc_lens", enc_lens, (B,), device)
            pos = torch.arange(frames.shape[1], device=device)[None, :]
            enc_out = encdec.encoder_apply(params["enc_layers"], frames.to(pdtype(cfg)), cfg, pos)
            enc_out = rmsnorm(enc_out, params["enc_norm"], cfg.norm_eps)
            return encdec.init_encdec_cache(params, cfg, B, S, enc_out, enc_lens)

        return encode

    def step(params, tokens):
        _check("tokens", tokens, (B, S), device)
        return prefill(params, tokens, cfg, max_len=S)

    return step
