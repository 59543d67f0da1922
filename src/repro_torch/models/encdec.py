"""Encoder-decoder backbone (seamless-m4t): port of ``repro/models/encdec.py``.

A stub frontend gives precomputed frame embeddings (B, Se, M); the encoder
is bidirectional self-attention with RoPE at the frame positions, the
decoder causal self-attention, then cross-attention to the encoder's
output, then a GELU MLP.  Layers are stacked on a leading axis as in the
port's other stacks (the reference's vmapped init).

The cache is ``{"self": {"k", "v"}, "cross": {"k", "v", "len"}}``: the
decoder's self-attention K/V (L, B, Smax, Hkv, D), written in place by
each decode step, and the cross-attention K/V (L, B, Se, Hkv, D) with the
valid frame counts (L, B) int32, computed once a session from the
encoder's output.

Padding, as in the reference: the encoder attends over every frame,
padding included, and ``decoder_apply``'s cross-attention reads all Se
frames; only the cross-attention decode step masks frames at or past
``len``.  So at ``enc_lens < Se`` a decode step does not match teacher
forcing, in either package (ROADMAP.md §3).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import (
    attn_apply, attn_decode, init_attn, init_kv_cache, precompute_cross_kv,
)
from repro_torch.models.layers import ones_init, pdtype, residual, rmsnorm
from repro_torch.models.mlp import gelu_mlp_apply, init_gelu_mlp
from repro_torch.models.transformer import _store, _unstack, layer_params, zero_aux
from repro_torch.sharding import constrain


def init_enc_layer(generator, cfg, layers: int | None = None, device="cuda") -> dict:
    lead = () if layers is None else (layers,)
    return {
        "ln1": ones_init((*lead, cfg.d_model), torch.float32, device),
        "attn": init_attn(generator, cfg, layers, device),
        "ln2": ones_init((*lead, cfg.d_model), torch.float32, device),
        "mlp": init_gelu_mlp(generator, cfg, layers, device),
    }


def enc_layer_apply(p, x, cfg, positions):
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    x = residual(x + attn_apply(p["attn"], h, cfg, positions, causal=False)[0])
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    return constrain(x + gelu_mlp_apply(p["mlp"], h), ("act_batch", "act_seq", "act_embed"))


def init_dec_layer(generator, cfg, layers: int | None = None, device="cuda") -> dict:
    lead = () if layers is None else (layers,)
    return {
        "ln1": ones_init((*lead, cfg.d_model), torch.float32, device),
        "attn": init_attn(generator, cfg, layers, device),
        "ln_x": ones_init((*lead, cfg.d_model), torch.float32, device),
        "xattn": init_attn(generator, cfg, layers, device, cross=True),
        "ln2": ones_init((*lead, cfg.d_model), torch.float32, device),
        "mlp": init_gelu_mlp(generator, cfg, layers, device),
    }


def dec_layer_apply(p, x, enc_out, cfg, positions):
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    x = residual(x + attn_apply(p["attn"], h, cfg, positions, causal=True)[0])
    h = rmsnorm(x, p["ln_x"], cfg.norm_eps)
    x = residual(x + attn_apply(p["xattn"], h, cfg, positions, causal=False,
                                kv_src=enc_out)[0])
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    return constrain(x + gelu_mlp_apply(p["mlp"], h), ("act_batch", "act_seq", "act_embed"))


def init_encdec_stacks(generator, cfg, device="cuda") -> dict:
    return {"enc_layers": init_enc_layer(generator, cfg, cfg.n_enc_layers, device),
            "dec_layers": init_dec_layer(generator, cfg, cfg.n_layers, device)}


def _stack(block, stacked, n: int, x, cfg):
    """``block(p, x) -> x`` over the ``n`` stacked layers.  Under autograd
    each layer is a checkpoint when ``cfg.remat == "block"`` (the
    reference's ``jax.checkpoint`` of its scanned body)."""
    remat = cfg.remat == "block" and torch.is_grad_enabled()
    for p in _unstack(stacked, n):
        x = checkpoint(block, p, x, use_reentrant=False) if remat else block(p, x)
    return x


def encoder_apply(stacked, frames, cfg, positions):
    """frames: (B, Se, M) -> the encoder's output (B, Se, M), before
    ``enc_norm``."""
    return _stack(lambda p, x: enc_layer_apply(p, x, cfg, positions), stacked,
                  cfg.n_enc_layers, frames, cfg)


def decoder_apply(stacked, x, enc_out, cfg, positions):
    """The decoder over the full sequence (teacher forcing); returns
    ``(x, aux)`` with the reference's zero MoE aux."""
    x = _stack(lambda p, x: dec_layer_apply(p, x, enc_out, cfg, positions), stacked,
               cfg.n_layers, x, cfg)
    return x, zero_aux(x.device)


@torch.no_grad()
def init_encdec_cache(params, cfg, batch: int, max_len: int, enc_out=None,
                      enc_lens=None) -> dict:
    """A zero self-attention cache of ``max_len`` slots and the
    cross-attention K/V of ``enc_out`` (B, Se, M) at ``enc_lens`` (B,)
    frames.  Without ``enc_out``, the reference's zeros path: zero frames
    of ``cfg.enc_len``, all valid."""
    device = params["emb"].device
    L = cfg.n_layers
    self_cache = init_kv_cache(cfg, batch, max_len, layers=L, device=device)
    if enc_out is None:
        enc_out = torch.zeros((batch, cfg.enc_len, cfg.d_model), dtype=pdtype(cfg),
                              device=device)
        enc_lens = torch.full((batch,), cfg.enc_len, dtype=torch.int32, device=device)
    enc_lens = enc_lens.to(device=device, dtype=torch.int32)
    cross = init_kv_cache(cfg, batch, enc_out.shape[1], layers=L, device=device)
    for i in range(L):
        kv = precompute_cross_kv(layer_params(params["dec_layers"], i)["xattn"], enc_out,
                                 enc_lens, cfg)
        _store(cross["k"][i], kv["k"])
        _store(cross["v"][i], kv["v"])
    cross["len"] = enc_lens.expand(L, batch).contiguous()
    return {"self": self_cache, "cross": cross}


def decoder_decode(stacked, x_t, cache, pos, cfg):
    """One decode step of every decoder layer: self-attention against (and
    into) the self cache, cross-attention against the encoder's K/V.
    x_t: (B, M); pos: (B,) int32.  Returns ``(x_t, cache)``."""
    self_cache, cross = cache["self"], cache["cross"]
    for i in range(cfg.n_layers):
        p = layer_params(stacked, i)
        h = rmsnorm(x_t, p["ln1"], cfg.norm_eps)
        a, _ = attn_decode(p["attn"], h, {"k": self_cache["k"][i], "v": self_cache["v"][i]},
                           pos, cfg)
        x_t = x_t + a
        h = rmsnorm(x_t, p["ln_x"], cfg.norm_eps)
        a, _ = attn_decode(p["xattn"], h, None, pos, cfg,
                           cross_kv={"k": cross["k"][i], "v": cross["v"][i],
                                     "len": cross["len"][i]})
        x_t = x_t + a
        h = rmsnorm(x_t, p["ln2"], cfg.norm_eps)
        x_t = x_t + gelu_mlp_apply(p["mlp"], h)
    return x_t, cache
