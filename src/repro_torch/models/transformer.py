"""Decoder stacks: dense / MoE, the Jamba hybrid and xLSTM (port of
``repro/models/transformer.py``).

Layer parameters are stacked on a leading ``L`` axis (``n_layers // 2``
for the xLSTM pairs, ``n_layers // attn_every`` for the Jamba super-blocks,
whose sub-layers are ``sub{i}`` keys), as the reference's vmapped init
leaves them, and a stack is a Python loop over layers (the reference's
``lax.scan``).  The KV cache is one real (L, B, Smax, Hkv, D) tensor per K
and V; each layer reads and writes its own slice in place.  The xLSTM and
Jamba caches hold each layer's recurrent state the same way.  The training
forms (``*_stack_train``) checkpoint each layer (each pair, each
super-block) when ``cfg.remat == "block"`` (the reference's
``_maybe_remat``).  A stack's ``aux`` sums the MoE losses and
``moe_drop_frac`` over its MoE layers, as the reference's ``_add_aux``
does (the drop fraction is summed, not averaged).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import attn_apply, attn_decode, init_attn, init_kv_cache
from repro_torch.models.layers import ones_init, rmsnorm
from repro_torch.models.mamba import init_mamba, init_mamba_state, mamba_apply, mamba_decode
from repro_torch.models.mlp import init_swiglu, swiglu_apply
from repro_torch.models.moe import init_moe, moe_apply, moe_decode
from repro_torch.models.xlstm import (
    init_mlstm, init_mlstm_state, init_slstm, init_slstm_state, mlstm_apply, mlstm_decode,
    slstm_apply, slstm_decode,
)


def zero_aux(device) -> dict:
    """The reference's ``ZERO_AUX``: the MoE losses of a stack without MoE."""
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in ("moe_aux", "moe_z", "moe_drop_frac")}


def _add_aux(a: dict | None, b: dict | None) -> dict | None:
    """The sum of two aux dicts; ``None`` (no MoE layer) adds nothing."""
    if a is None or b is None:
        return b if a is None else a
    return {k: a[k] + b[k] for k in a}


def _ffn_apply(p, h, cfg, aux: dict | None):
    """A layer's MoE or SwiGLU MLP over (B, S, M); returns ``(y, aux)``,
    a MoE layer's losses added to ``aux`` (``None`` until a MoE layer)."""
    if "moe" in p:
        y, a = moe_apply(p["moe"], h, cfg)
        return y, _add_aux(aux, a)
    return swiglu_apply(p["mlp"], h), aux


def _ffn_decode(p, h, cfg):
    """A layer's MoE or SwiGLU MLP over one token a row, (B, M)."""
    if "moe" in p:
        return moe_decode(p["moe"], h, cfg)
    return swiglu_apply(p["mlp"], h)


# ===========================================================================
# Dense / MoE decoder layers
# ===========================================================================

def init_decoder_layer(generator, cfg, layers: int | None = None, device="cuda") -> dict:
    lead = () if layers is None else (layers,)
    p = {
        "ln1": ones_init((*lead, cfg.d_model), torch.float32, device),
        "attn": init_attn(generator, cfg, layers, device),
        "ln2": ones_init((*lead, cfg.d_model), torch.float32, device),
    }
    if cfg.moe is not None and cfg.moe.every == 1:
        p["moe"] = init_moe(generator, cfg, layers, device)
    else:
        p["mlp"] = init_swiglu(generator, cfg, layers, device)
    return p


def layer_params(stacked: dict, i: int) -> dict:
    """Layer ``i``'s parameters: views into the stacked tensors."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i] for k, v in stacked.items()}


def decoder_layer_apply(p, x, cfg, positions):
    """Returns the layer output, the K and V its attention used, and its
    MoE aux (``None`` for a dense layer)."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    a, k, v = attn_apply(p["attn"], h, cfg, positions)
    x = x + a
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    y, aux = _ffn_apply(p, h, cfg, None)
    return x + y, k, v, aux


def decoder_layer_decode(p, x_t, cache, pos, cfg):
    h = rmsnorm(x_t, p["ln1"], cfg.norm_eps)
    a, cache = attn_decode(p["attn"], h, cache, pos, cfg)
    x_t = x_t + a
    h = rmsnorm(x_t, p["ln2"], cfg.norm_eps)
    return x_t + _ffn_decode(p, h, cfg), cache


def init_dense_stack(generator, cfg, device="cuda") -> dict:
    return init_decoder_layer(generator, cfg, layers=cfg.n_layers, device=device)


def dense_stack_apply(stacked, x, cfg, positions, kv_out: dict | None = None):
    """Run every layer over the full sequence; returns ``(x, aux)``.  With
    ``kv_out`` (a cache of length S), each layer's K and V are written
    into it."""
    aux = zero_aux(x.device)
    for i in range(cfg.n_layers):
        x, k, v, a = decoder_layer_apply(layer_params(stacked, i), x, cfg, positions)
        aux = _add_aux(aux, a)
        if kv_out is not None:
            kv_out["k"][i].copy_(k)
            kv_out["v"][i].copy_(v)
    return x, aux


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
    """``block(p, x) -> (x, aux or None)`` over the ``n`` stacked blocks
    with autograd, each one a checkpoint when ``cfg.remat == "block"``;
    returns ``(x, aux)`` with the blocks' aux summed."""
    aux = zero_aux(x.device)
    for p in _unstack(stacked, n):
        if cfg.remat == "block":
            x, a = checkpoint(block, p, x, use_reentrant=False)
        else:
            x, a = block(p, x)
        aux = _add_aux(aux, a)
    return x, aux


def dense_stack_train(stacked, x, cfg, positions):
    """The stack over the full sequence with autograd, for training; returns
    ``(x, aux)`` as the reference's ``dense_stack_apply`` does.  With
    ``cfg.remat == "block"`` each layer is a checkpoint: its activations are
    recomputed in the backward, which runs its attention forward again."""
    def layer(p, x):
        x, _, _, aux = decoder_layer_apply(p, x, cfg, positions)
        return x, aux

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
# Jamba hybrid super-blocks (attn_every sub-layers a block, one attention)
# ===========================================================================

def _jamba_layout(cfg):
    """``(per, attn_pos, n_blocks, moe_every)``: sub-layers a block, the
    attention's slot (the middle one), blocks, and MoE at the odd slots
    when ``moe.every == 2``."""
    per = cfg.attn_every
    moe_every = cfg.moe.every if cfg.moe else 0
    return per, per // 2, cfg.n_layers // per, moe_every


def init_jamba_block(generator, cfg, blocks: int | None = None, device="cuda") -> dict:
    per, attn_pos, _, moe_every = _jamba_layout(cfg)
    lead = () if blocks is None else (blocks,)
    out = {}
    for i in range(per):
        lp = {"ln1": ones_init((*lead, cfg.d_model), torch.float32, device),
              "ln2": ones_init((*lead, cfg.d_model), torch.float32, device)}
        if i == attn_pos:
            lp["attn"] = init_attn(generator, cfg, blocks, device)
        else:
            lp["mamba"] = init_mamba(generator, cfg, blocks, device)
        if moe_every and i % moe_every == 1:
            lp["moe"] = init_moe(generator, cfg, blocks, device)
        else:
            lp["mlp"] = init_swiglu(generator, cfg, blocks, device)
        out[f"sub{i}"] = lp
    return out


def init_jamba_stack(generator, cfg, device="cuda") -> dict:
    return init_jamba_block(generator, cfg, _jamba_layout(cfg)[2], device)


def jamba_block_apply(p, x, cfg, positions):
    """One super-block over the full sequence; returns ``(x, aux)``."""
    aux = None
    for i in range(_jamba_layout(cfg)[0]):
        lp = p[f"sub{i}"]
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        if "attn" in lp:
            x = x + attn_apply(lp["attn"], h, cfg, positions)[0]
        else:
            x = x + mamba_apply(lp["mamba"], h, cfg)
        h = rmsnorm(x, lp["ln2"], cfg.norm_eps)
        y, aux = _ffn_apply(lp, h, cfg, aux)
        x = x + y
    return x, aux


def jamba_stack_apply(stacked, x, cfg, positions):
    aux = zero_aux(x.device)
    for b in range(_jamba_layout(cfg)[2]):
        x, a = jamba_block_apply(layer_params(stacked, b), x, cfg, positions)
        aux = _add_aux(aux, a)
    return x, aux


def jamba_stack_train(stacked, x, cfg, positions):
    """:func:`jamba_stack_apply` with autograd; a super-block is one
    checkpoint under ``cfg.remat == "block"``."""
    return _train_loop(lambda p, x: jamba_block_apply(p, x, cfg, positions), stacked,
                       _jamba_layout(cfg)[2], x, cfg)


def init_jamba_cache(cfg, batch: int, max_len: int, device="cuda") -> dict:
    """The reference's layout, as real zero tensors: ``attn`` K/V
    (n_blocks, B, Smax, Hkv, D); ``mamba`` ``h`` (n_blocks, per - 1, B,
    d_inner, N) f32 and ``conv`` (n_blocks, per - 1, B, K - 1, d_inner)."""
    per, _, n_blocks, _ = _jamba_layout(cfg)
    return {"attn": init_kv_cache(cfg, batch, max_len, layers=n_blocks, device=device),
            "mamba": init_mamba_state(cfg, batch, (n_blocks, per - 1), device)}


def jamba_block_decode(p, x_t, block_cache, pos, cfg):
    """One token through a super-block; ``block_cache`` (one block's views)
    is updated in place."""
    mi = 0
    for i in range(_jamba_layout(cfg)[0]):
        lp = p[f"sub{i}"]
        h = rmsnorm(x_t, lp["ln1"], cfg.norm_eps)
        if "attn" in lp:
            a, _ = attn_decode(lp["attn"], h, block_cache["attn"], pos, cfg)
        else:
            a, new = mamba_decode(lp["mamba"], h, layer_params(block_cache["mamba"], mi), cfg)
            for k, v in new.items():
                block_cache["mamba"][k][mi].copy_(v)
            mi += 1
        x_t = x_t + a
        h = rmsnorm(x_t, lp["ln2"], cfg.norm_eps)
        x_t = x_t + _ffn_decode(lp, h, cfg)
    return x_t, block_cache


def jamba_stack_decode(stacked, x_t, cache, pos, cfg):
    for b in range(_jamba_layout(cfg)[2]):
        x_t, _ = jamba_block_decode(layer_params(stacked, b), x_t, layer_params(cache, b), pos,
                                    cfg)
    return x_t, cache


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
    return _train_loop(lambda p, x: (xlstm_pair_apply(p, x, cfg), None), stacked,
                       _xlstm_pairs(cfg), x, cfg)


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
