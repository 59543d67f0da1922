"""Model API of the port (dense decoder and xLSTM families).

    init_params(cfg, seed, device)            -> params dict
    loss_fn(params, batch, cfg)               -> (loss, metrics)      [train]
    forward_train(params, batch, cfg)         -> (logits, aux)        [train]
    prefill(params, tokens, cfg, max_len)     -> (logits_last, cache)
    init_cache(params, cfg, batch, max_len)   -> cache dict
    decode_step(params, cache, token, pos, cfg) -> (logits, cache)

Port of the decoder-only families of ``repro/models/model.py``: dense,
moe (the dense stack with MoE MLPs), vlm (the dense stack with QK-norm),
hybrid (Jamba super-blocks) and ssm (xLSTM pairs); the encoder-decoder
(audio) family is not ported yet.  :func:`count_params_analytic` covers
every family, because the job profiles of the whole zoo need it.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import transformer as tfm
from repro_torch.models.layers import embed_init, ones_init, pdtype, rmsnorm


PORTED_FAMILIES = ("dense", "moe", "vlm", "hybrid", "ssm")


def require_ported(cfg) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(f"{cfg.name}: the {cfg.family} family is not ported yet")


def init_params(cfg, seed: int = 0, device="cuda") -> dict:
    """Random weights drawn from ``torch.Generator(device).manual_seed(seed)``."""
    require_ported(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = pdtype(cfg)
    p: dict = {"emb": embed_init(gen, (cfg.vocab_size, cfg.d_model), dt, device)}
    if cfg.family == "hybrid":
        p["blocks"] = tfm.init_jamba_stack(gen, cfg, device)
    elif cfg.family == "ssm":
        p["pairs"] = tfm.init_xlstm_stack(gen, cfg, device)
    else:  # dense / moe / vlm
        p["layers"] = tfm.init_dense_stack(gen, cfg, device)
    p["final_norm"] = ones_init((cfg.d_model,), torch.float32, device)
    if not cfg.tie_embeddings:
        p["lm_head"] = embed_init(gen, (cfg.d_model, cfg.vocab_size), dt, device)
    return p


def _embed(p, tokens, cfg):
    return p["emb"][tokens].to(pdtype(cfg))


def _logits(p, x, cfg):
    h = rmsnorm(x, p["final_norm"], cfg.norm_eps)
    w = p["emb"].T if cfg.tie_embeddings else p["lm_head"]
    return (h @ w.to(h.dtype)).float()


# ===========================================================================
# Training
# ===========================================================================

def _train_stack(params, tokens, cfg):
    require_ported(cfg)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    x = _embed(params, tokens, cfg)
    if cfg.family == "hybrid":
        return tfm.jamba_stack_train(params["blocks"], x, cfg, positions)
    if cfg.family == "ssm":
        return tfm.xlstm_stack_train(params["pairs"], x, cfg, positions)
    return tfm.dense_stack_train(params["layers"], x, cfg, positions)


def forward_train(params, batch, cfg):
    """batch: {"tokens": (B, S) int} -> (logits (B, S, V) f32, aux)."""
    x, aux = _train_stack(params, batch["tokens"], cfg)
    return _logits(params, x, cfg), aux


LOSS_CHUNK = 512  # sequence-chunked CE: per-chunk logits only (memory cap)


def _chunk_ce(params, x_c, labels_c, cfg):
    """CE sums for one token chunk; checkpointed, so its logits are transient.

    The gold logit is a ``gather``; the reference contracts a one-hot (to
    keep the vocab axis shardable under GSPMD) and gets the same value."""
    with torch.profiler.record_function("chunked_ce"):
        logits = _logits(params, x_c, cfg)                     # (B, sc, V) f32
        mask = (labels_c >= 0).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels_c.clamp_min(0).long()[..., None])[..., 0]
        ce_sum = ((lse - gold) * mask).sum()
        z_sum = (lse * mask).square().sum()
        return ce_sum, z_sum, mask.sum()


def loss_fn(params, batch, cfg):
    """Next-token CE + z-loss (+ the MoE aux losses). labels: (B, S) int,
    -1 = masked.

    The unembedding + CE is sequence-chunked (each chunk of ``LOSS_CHUNK``
    tokens checkpointed): the (B, S, V) logits are never alive at once, at
    the cost of one more logits product in the backward.  Returns
    ``(total, metrics)``; the metrics are detached 0-dim tensors with the
    reference's keys."""
    x, aux = _train_stack(params, batch["tokens"], cfg)
    labels = batch["labels"]
    S = labels.shape[1]
    sc = min(LOSS_CHUNK, S)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    ce_sum, z_sum, n_tok = zero, zero, zero
    for lo in range(0, S, sc):
        c, z, n = checkpoint(_chunk_ce, params, x[:, lo:lo + sc], labels[:, lo:lo + sc], cfg,
                             use_reentrant=False)
        ce_sum, z_sum, n_tok = ce_sum + c, z_sum + z, n_tok + n

    n_tok = torch.clamp(n_tok, min=1.0)
    loss = ce_sum / n_tok
    z_loss = 1e-4 * z_sum / n_tok
    total = loss + z_loss + aux["moe_aux"] + aux["moe_z"]
    metrics = {"loss": loss.detach(), "z_loss": z_loss.detach(),
               "moe_aux": aux["moe_aux"].detach(), "moe_drop_frac": aux["moe_drop_frac"].detach(),
               "tokens": n_tok.detach()}
    return total, metrics


# ===========================================================================
# Inference
# ===========================================================================

def init_cache(params, cfg, batch: int, max_len: int) -> dict:
    require_ported(cfg)
    device = params["emb"].device
    if cfg.family == "hybrid":
        return tfm.init_jamba_cache(cfg, batch, max_len, device=device)
    if cfg.family == "ssm":
        return tfm.init_xlstm_cache(cfg, batch, max_len, device=device)
    return tfm.init_dense_cache(cfg, batch, max_len, device=device)


@torch.no_grad()
def decode_step(params, cache, token, pos, cfg):
    """token: (B,) int; pos: (B,) int32 -> (logits (B, V) f32, cache).

    The cache is updated in place and returned."""
    x_t = _embed(params, token[:, None], cfg)[:, 0]        # (B, M)
    if cfg.family == "hybrid":
        x_t, cache = tfm.jamba_stack_decode(params["blocks"], x_t, cache, pos, cfg)
    elif cfg.family == "ssm":
        x_t, cache = tfm.xlstm_stack_decode(params["pairs"], x_t, cache, pos, cfg)
    else:
        x_t, cache = tfm.dense_stack_decode(params["layers"], x_t, cache, pos, cfg)
    return _logits(params, x_t, cfg), cache


@torch.no_grad()
def prefill(params, tokens, cfg, max_len: int):
    """Full-sequence prefill -> (last-position logits, cache).

    As in the reference, the cache is ``S`` long whatever ``max_len`` says;
    its K/V come from each layer's attention call (roped keys, QK-normed
    for the vlm family: the reference stores raw keys there).  For the
    ``hybrid`` and ``ssm`` families the reference returns the last logits
    of the parallel forward and a *fresh* zero cache (its documented
    limitation: serving code rebuilds the recurrent state by a decode
    warm-up); so does this."""
    require_ported(cfg)
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None, :]
    x = _embed(params, tokens, cfg)
    if cfg.family in ("hybrid", "ssm"):
        if cfg.family == "hybrid":
            x, _ = tfm.jamba_stack_apply(params["blocks"], x, cfg, positions)
        else:
            x = tfm.xlstm_stack_apply(params["pairs"], x, cfg, positions)
        return _logits(params, x[:, -1, :], cfg), init_cache(params, cfg, B, S)
    cache = tfm.init_dense_cache(cfg, B, S, device=tokens.device)
    x, _ = tfm.dense_stack_apply(params["layers"], x, cfg, positions, kv_out=cache)
    return _logits(params, x[:, -1, :], cfg), cache


# ===========================================================================
# Analytics
# ===========================================================================

def _attn_shapes(cfg, bias: bool) -> dict:
    M, Q, KV = cfg.d_model, cfg.q_dim, cfg.kv_dim
    out = {"wq": (M, Q), "wk": (M, KV), "wv": (M, KV), "wo": (Q, M)}
    if bias:
        out.update({"bq": (Q,), "bk": (KV,), "bv": (KV,)})
    return out


def _swiglu_shapes(M: int, F: int) -> dict:
    return {"wg": (M, F), "wu": (M, F), "wd": (F, M)}


def _moe_shapes(cfg) -> dict:
    m = cfg.moe
    M, F, E = cfg.d_model, m.d_expert, m.n_routed
    out = {"router": (M, E), "experts_wg": (E, M, F), "experts_wu": (E, M, F),
           "experts_wd": (E, F, M)}
    if m.n_shared > 0:
        out["shared"] = _swiglu_shapes(M, m.n_shared * F)
    return out


def _mamba_shapes(cfg) -> dict:
    mc = cfg.mamba
    M, D, N = cfg.d_model, mc.expand * cfg.d_model, mc.d_state
    R = mc.dt_rank or math.ceil(cfg.d_model / 16)
    return {"w_in": (M, 2 * D), "conv_w": (mc.d_conv, D), "conv_b": (D,),
            "w_x": (D, R + 2 * N), "w_dt": (R, D), "b_dt": (D,), "A_log": (D, N),
            "D": (D,), "w_out": (D, M)}


def _xlstm_pair_shapes(cfg) -> dict:
    M, H = cfg.d_model, cfg.n_heads
    D = int(cfg.xlstm.expand_m * M)
    F = int(round(cfg.xlstm.proj_factor_s * M))
    dh = M // H
    return {
        "mlstm": {"norm": (M,), "w_up": (M, 2 * D), "conv_w": (cfg.xlstm.d_conv, D),
                  "conv_b": (D,), "wq": (D, D), "wk": (D, D), "wv": (D, D),
                  "w_gates": (D, 2 * H), "b_gates": (2 * H,), "onorm": (D,),
                  "w_down": (D, M)},
        "slstm": {"norm": (M,), "slstm_w": (M, 4 * M), "slstm_r": (H, 4, dh, dh),
                  "slstm_b": (4 * M,), "ffn_norm": (M,), "w_up": (M, 2 * F),
                  "w_down": (F, M)},
    }


def _stacked(n: int, tree: dict) -> dict:
    return {k: _stacked(n, v) if isinstance(v, dict) else (n, *v) for k, v in tree.items()}


def param_shapes(cfg) -> dict:
    """Shape of every parameter ``repro.models.model.init_params`` makes,
    for every family, as a nested dict (layer stacks lead with their depth)."""
    M = cfg.d_model
    p: dict = {"emb": (cfg.vocab_size, M)}
    if cfg.enc_dec:
        gelu = {"wu": (M, cfg.d_ff), "wd": (cfg.d_ff, M)}
        enc = {"ln1": (M,), "attn": _attn_shapes(cfg, cfg.qkv_bias), "ln2": (M,), "mlp": gelu}
        dec = {"ln1": (M,), "attn": _attn_shapes(cfg, cfg.qkv_bias), "ln_x": (M,),
               "xattn": _attn_shapes(cfg, False), "ln2": (M,), "mlp": gelu}
        p["enc_layers"] = _stacked(cfg.n_enc_layers, enc)
        p["dec_layers"] = _stacked(cfg.n_layers, dec)
        p["enc_norm"] = (M,)
    elif cfg.family == "hybrid":
        per, attn_pos = cfg.attn_every, cfg.attn_every // 2
        moe_every = cfg.moe.every if cfg.moe else 0
        block = {}
        for i in range(per):
            sub = {"ln1": (M,), "ln2": (M,)}
            if i == attn_pos:
                sub["attn"] = _attn_shapes(cfg, cfg.qkv_bias)
            else:
                sub["mamba"] = _mamba_shapes(cfg)
            if moe_every and i % moe_every == 1:
                sub["moe"] = _moe_shapes(cfg)
            else:
                sub["mlp"] = _swiglu_shapes(M, cfg.d_ff)
            block[f"sub{i}"] = sub
        p["blocks"] = _stacked(cfg.n_layers // per, block)
    elif cfg.family == "ssm":
        p["pairs"] = _stacked(cfg.n_layers // 2, _xlstm_pair_shapes(cfg))
    else:  # dense / moe / vlm
        layer = {"ln1": (M,), "attn": _attn_shapes(cfg, cfg.qkv_bias), "ln2": (M,)}
        if cfg.moe is not None and cfg.moe.every == 1:
            layer["moe"] = _moe_shapes(cfg)
        else:
            layer["mlp"] = _swiglu_shapes(M, cfg.d_ff)
        p["layers"] = _stacked(cfg.n_layers, layer)
    p["final_norm"] = (M,)
    if not cfg.tie_embeddings:
        p["lm_head"] = (M, cfg.vocab_size)
    return p


def count_params_analytic(cfg, active_only: bool = False) -> int:
    """Exact parameter count; ``active_only`` scales each routed-expert leaf
    by top_k / n_routed (rounded down per leaf, as the reference does)."""
    total = 0

    def visit(tree):
        nonlocal total
        for name, v in tree.items():
            if isinstance(v, dict):
                visit(v)
                continue
            n = math.prod(v)
            if active_only and name.startswith("experts_") and cfg.moe is not None:
                n = int(n * cfg.moe.top_k / cfg.moe.n_routed)
            total += n

    visit(param_shapes(cfg))
    return int(total)
