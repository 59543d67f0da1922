"""Serve step factories on one device.

Port of the serve half of ``repro/runtime/steps.py``.  The reference jits
each step with the ``NamedSharding`` trees of a mesh and donates the cache
to the decode step; here a step is a callable over
:func:`repro_torch.models.model.prefill` and
:func:`repro_torch.models.model.decode_step` on one device.  There are no
meshes or shardings (multi-GPU is out of scope), and the donated cache is
the decode step's in-place cache update.  The encoder-decoder prefill (the
encoder pass and the cross-attention K/V) waits for the audio family.
"""
from __future__ import annotations

import torch

from repro_torch.models.model import decode_step, init_cache, prefill, require_ported


def _check(what: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if tuple(t.shape) != shape or t.device.type != device.type:
        raise ValueError(f"{what}: got {tuple(t.shape)} on {t.device}, the step takes {shape} "
                         f"on {device}")


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
    ``ShapeConfig``'s (global_batch, seq_len) tokens."""
    if cfg.enc_dec:
        raise NotImplementedError(f"{cfg.name}: the encoder-decoder prefill is not ported yet")
    require_ported(cfg)
    device = torch.device(device)
    B, S = shape.global_batch, shape.seq_len

    def step(params, tokens):
        _check("tokens", tokens, (B, S), device)
        return prefill(params, tokens, cfg, max_len=S)

    return step
