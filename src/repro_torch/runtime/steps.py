"""Serve step factories on one device.

Port of the serve half of ``repro/runtime/steps.py``.  The reference jits
each step with the ``NamedSharding`` trees of a mesh and donates the cache
to the decode step; here a step is a callable over
:func:`repro_torch.models.model.prefill` and
:func:`repro_torch.models.model.decode_step` on one device.  There are no
meshes or shardings (multi-GPU is out of scope), and the donated cache is
the decode step's in-place cache update.  The encoder-decoder's prefill
step is the encoder pass and the cross-attention K/V.
"""
from __future__ import annotations

import torch

from repro_torch.models import encdec
from repro_torch.models.layers import pdtype, rmsnorm
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
