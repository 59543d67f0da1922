"""Decoder stacks: dense and xLSTM (port of those parts of
``repro/models/transformer.py``).

Layer parameters are stacked on a leading ``L`` axis (``n_layers // 2``
for the xLSTM pairs), as the reference's vmapped init leaves them, and a
stack is a Python loop over layers (the reference's ``lax.scan``).  The KV
cache is one real (L, B, Smax, Hkv, D) tensor per K and V; each layer reads
and writes its own slice in place.  The xLSTM cache holds each pair's
recurrent state the same way.  The training forms, :func:`dense_stack_train`
and :func:`xlstm_stack_train`, checkpoint each layer (each pair) when
``cfg.remat == "block"`` (the reference's ``_maybe_remat``).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import attn_apply, attn_decode, init_attn, init_kv_cache
from repro_torch.models.layers import ones_init, rmsnorm
from repro_torch.models.mlp import init_swiglu, swiglu_apply
from repro_torch.models.xlstm import (
    init_mlstm, init_mlstm_state, init_slstm, init_slstm_state, mlstm_apply, mlstm_decode,
    slstm_apply, slstm_decode,
)


def init_decoder_layer(generator, cfg, layers: int | None = None, device="cuda") -> dict:
    lead = () if layers is None else (layers,)
    return {
        "ln1": ones_init((*lead, cfg.d_model), torch.float32, device),
        "attn": init_attn(generator, cfg, layers, device),
        "ln2": ones_init((*lead, cfg.d_model), torch.float32, device),
        "mlp": init_swiglu(generator, cfg, layers, device),
    }


def layer_params(stacked: dict, i: int) -> dict:
    """Layer ``i``'s parameters: views into the stacked tensors."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i] for k, v in stacked.items()}


def decoder_layer_apply(p, x, cfg, positions):
    """Returns the layer output and the layer's roped K and V."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    a, k, v = attn_apply(p["attn"], h, cfg, positions)
    x = x + a
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + swiglu_apply(p["mlp"], h), k, v


def decoder_layer_decode(p, x_t, cache, pos, cfg):
    h = rmsnorm(x_t, p["ln1"], cfg.norm_eps)
    a, cache = attn_decode(p["attn"], h, cache, pos, cfg)
    x_t = x_t + a
    h = rmsnorm(x_t, p["ln2"], cfg.norm_eps)
    return x_t + swiglu_apply(p["mlp"], h[:, None, :])[:, 0], cache


def init_dense_stack(generator, cfg, device="cuda") -> dict:
    return init_decoder_layer(generator, cfg, layers=cfg.n_layers, device=device)


def dense_stack_apply(stacked, x, cfg, positions, kv_out: dict | None = None):
    """Run every layer over the full sequence.  With ``kv_out`` (a cache of
    length S), each layer's K and V are written into it."""
    for i in range(cfg.n_layers):
        x, k, v = decoder_layer_apply(layer_params(stacked, i), x, cfg, positions)
        if kv_out is not None:
            kv_out["k"][i].copy_(k)
            kv_out["v"][i].copy_(v)
    return x


def zero_aux(device) -> dict:
    """The reference's ``ZERO_AUX``: the MoE losses of a stack without MoE."""
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in ("moe_aux", "moe_z", "moe_drop_frac")}


def _unstack(stacked: dict, n: int) -> list[dict]:
    """Each layer's parameters as views cut by one ``unbind`` per leaf: its
    backward stacks a leaf's layer gradients once, where indexing layer by
    layer would add up one full-size gradient per layer."""
    out = [{} for _ in range(n)]
    for k, v in stacked.items():
        parts = _unstack(v, n) if isinstance(v, dict) else v.unbind(0)
        for layer, part in zip(out, parts):
            layer[k] = part
    return out


def _train_loop(block, stacked, n: int, x, cfg):
    """``block(p, x)`` over the ``n`` stacked blocks with autograd, each one
    a checkpoint when ``cfg.remat == "block"``; returns ``(x, aux)``."""
    for p in _unstack(stacked, n):
        if cfg.remat == "block":
            x = checkpoint(block, p, x, use_reentrant=False)
        else:
            x = block(p, x)
    return x, zero_aux(x.device)


def dense_stack_train(stacked, x, cfg, positions):
    """The stack over the full sequence with autograd, for training; returns
    ``(x, aux)`` as the reference's ``dense_stack_apply`` does.  With
    ``cfg.remat == "block"`` each layer is a checkpoint: its activations are
    recomputed in the backward, which runs its attention forward again."""
    def layer(p, x):
        return decoder_layer_apply(p, x, cfg, positions)[0]

    return _train_loop(layer, stacked, cfg.n_layers, x, cfg)


def dense_stack_decode(stacked, x_t, cache, pos, cfg):
    for i in range(cfg.n_layers):
        layer_cache = {"k": cache["k"][i], "v": cache["v"][i]}
        x_t, _ = decoder_layer_decode(layer_params(stacked, i), x_t, layer_cache, pos, cfg)
    return x_t, cache


def init_dense_cache(cfg, batch: int, max_len: int, device="cuda") -> dict:
    """A real zero cache (L, B, Smax, Hkv, D), not a broadcast view: decode
    writes into it in place."""
    return init_kv_cache(cfg, batch, max_len, layers=cfg.n_layers, device=device)


# ===========================================================================
# xLSTM pair stack (pattern "ms": one mLSTM + one sLSTM per pair)
# ===========================================================================

def _xlstm_pairs(cfg) -> int:
    assert cfg.xlstm.pattern == "ms"
    return cfg.n_layers // 2


def init_xlstm_pair(generator, cfg, pairs: int | None = None, device="cuda") -> dict:
    return {"mlstm": init_mlstm(generator, cfg, pairs, device),
            "slstm": init_slstm(generator, cfg, pairs, device)}


def init_xlstm_stack(generator, cfg, device="cuda") -> dict:
    return init_xlstm_pair(generator, cfg, _xlstm_pairs(cfg), device)


def xlstm_pair_apply(p, x, cfg):
    return slstm_apply(p["slstm"], mlstm_apply(p["mlstm"], x, cfg), cfg)


def xlstm_stack_apply(stacked, x, cfg, positions=None):
    """Every pair over the full sequence (no recurrent state comes out)."""
    for i in range(_xlstm_pairs(cfg)):
        x = xlstm_pair_apply(layer_params(stacked, i), x, cfg)
    return x


def xlstm_stack_train(stacked, x, cfg, positions=None):
    """:func:`xlstm_stack_apply` with autograd, for training; returns
    ``(x, aux)``.  With ``cfg.remat == "block"`` each *pair* is one
    checkpoint, as the reference's ``_maybe_remat(body)`` makes its scan
    body, so the backward runs the pair's sLSTM loop again."""
    return _train_loop(lambda p, x: xlstm_pair_apply(p, x, cfg), stacked, _xlstm_pairs(cfg),
                       x, cfg)


def init_xlstm_cache(cfg, batch: int, max_len: int = 0, device="cuda") -> dict:
    """Each pair's zero recurrent state, stacked on the pair axis as real
    tensors (the reference broadcasts one state; decode writes here)."""
    n = _xlstm_pairs(cfg)
    return {"mlstm": init_mlstm_state(cfg, batch, n, device),
            "slstm": init_slstm_state(cfg, batch, n, device)}


def xlstm_stack_decode(stacked, x_t, cache, pos, cfg):
    """One token through every pair; each pair's new state is copied into
    its slice of ``cache`` in place."""
    for i in range(_xlstm_pairs(cfg)):
        p = layer_params(stacked, i)
        for name, fn in (("mlstm", mlstm_decode), ("slstm", slstm_decode)):
            x_t, new = fn(p[name], x_t, layer_params(cache[name], i), cfg)
            for k, v in new.items():
                cache[name][k][i].copy_(v)
    return x_t, cache
