"""Model API of the port (every family of the reference).

    init_params(cfg, seed, device)            -> params dict
    loss_fn(params, batch, cfg)               -> (loss, metrics)      [train]
    forward_train(params, batch, cfg)         -> (logits, aux)        [train]
    prefill(params, tokens, cfg, max_len)     -> (logits_last, cache)
    init_cache(params, cfg, batch, max_len)   -> cache dict
    decode_step(params, cache, token, pos, cfg) -> (logits, cache)

Port of ``repro/models/model.py``: dense, moe (the dense stack with MoE
MLPs), vlm (the dense stack with QK-norm), hybrid (Jamba super-blocks), ssm
(xLSTM pairs) and audio (the encoder-decoder of ``encdec.py``; its batches
add ``"frames"`` (B, Se, M), and its prefill is the serve step's encoder
pass, ``runtime/steps.py: make_prefill_step``).

Under an active mesh (the sharded steps of ``runtime/steps.py``) the
parameters and activations are DTensors and the ``constrain`` calls lay
them out by the rule table; the tensors the model makes itself
(positions, RoPE tables, masks, the zero aux) stay plain and count as
replicated (``implicit_replication`` around the step), which issues no
collective.  The embedding gather and the chunked CE over a vocab-sharded
table run on local shards (:func:`_sharded_embed`, :func:`_sharded_lse_gold`).
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from repro_torch.models import encdec, transformer as tfm
from repro_torch.models.layers import embed_init, ones_init, pdtype, rmsnorm
from repro_torch.sharding import constrain
from repro_torch.sharding.specs import relayout, shard_offset


PORTED_FAMILIES = ("dense", "moe", "vlm", "hybrid", "ssm", "audio")


def require_ported(cfg) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(f"{cfg.name}: the {cfg.family} family is not ported yet")


def init_params(cfg, seed: int = 0, device="cuda") -> dict:
    """Random weights drawn from ``torch.Generator(device).manual_seed(seed)``;
    on the ``meta`` device, shapes and dtypes only (nothing is drawn)."""
    require_ported(cfg)
    meta = torch.device(device).type == "meta"
    gen = None if meta else torch.Generator(device=device).manual_seed(seed)
    dt = pdtype(cfg)
    p: dict = {"emb": embed_init(gen, (cfg.vocab_size, cfg.d_model), dt, device)}
    if cfg.enc_dec:
        p.update(encdec.init_encdec_stacks(gen, cfg, device))
        p["enc_norm"] = ones_init((cfg.d_model,), torch.float32, device)
    elif cfg.family == "hybrid":
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
    x = _sharded_embed(p["emb"], tokens) if isinstance(p["emb"], DTensor) else p["emb"][tokens]
    return constrain(x.to(pdtype(cfg)), ("act_batch", "act_seq", "act_embed"))


def _sharded_embed(emb, tokens):
    """The gather from a vocab-sharded DTensor table: each rank gathers the
    ids in its vocab shard (zero rows for the others), a ``Partial`` sum
    over the vocab-sharding mesh dims that the caller's ``constrain``
    reduces (the reference's GSPMD gather).  The table's gradient is that
    rank's shard's, summed over the mesh dims that shard the batch.
    (DTensor's own ``embedding`` rule cannot take its gradient back from a
    ``Partial`` sum.)"""
    mesh, e_pl = emb.device_mesh, list(emb.placements)
    t_pl = list(tokens.placements) if isinstance(tokens, DTensor) else [Replicate()] * mesh.ndim
    assert not any(isinstance(a, Shard) and a.dim == 1 for a in e_pl), e_pl
    out_pl = [Partial() if isinstance(a, Shard) else b for a, b in zip(e_pl, t_pl)]
    g_pl = [Partial() if isinstance(b, Shard) and not isinstance(a, Shard) else a
            for a, b in zip(e_pl, t_pl)]
    idx, n = shard_offset(mesh, e_pl, 0)

    def local(e, tok):
        if n == 1:
            return e[tok]
        tok = tok.long() - idx * e.shape[0]
        mine = (tok >= 0) & (tok < e.shape[0])
        return e[tok.clamp(0, e.shape[0] - 1)] * mine[..., None].to(e.dtype)

    return local_map(local, out_placements=out_pl, in_placements=(e_pl, t_pl),
                     in_grad_placements=(g_pl, t_pl), device_mesh=mesh,
                     redistribute_inputs=True)(emb, tokens)


def _logits(p, x, cfg):
    h = rmsnorm(x, p["final_norm"], cfg.norm_eps)
    w = p["emb"].T if cfg.tie_embeddings else p["lm_head"]
    logits = (h @ w.to(h.dtype)).float()
    return constrain(logits, ("act_batch", "act_seq", "act_vocab") if logits.ndim == 3
                     else ("act_batch", "act_vocab"))


# ===========================================================================
# Training
# ===========================================================================

def _train_stack(params, batch, cfg):
    require_ported(cfg)
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    x = _embed(params, tokens, cfg)
    if cfg.enc_dec:
        frames = batch["frames"].to(pdtype(cfg))
        enc_pos = torch.arange(frames.shape[1], device=frames.device)[None, :]
        enc_out = encdec.encoder_apply(params["enc_layers"], frames, cfg, enc_pos)
        enc_out = rmsnorm(enc_out, params["enc_norm"], cfg.norm_eps)
        return encdec.decoder_apply(params["dec_layers"], x, enc_out, cfg, positions)
    if cfg.family == "hybrid":
        return tfm.jamba_stack_train(params["blocks"], x, cfg, positions)
    if cfg.family == "ssm":
        return tfm.xlstm_stack_train(params["pairs"], x, cfg, positions)
    return tfm.dense_stack_train(params["layers"], x, cfg, positions)


def forward_train(params, batch, cfg):
    """batch: {"tokens": (B, S) int; the audio family adds "frames"
    (B, Se, M)} -> (logits (B, S, V) f32, aux)."""
    x, aux = _train_stack(params, batch, cfg)
    return _logits(params, x, cfg), aux


LOSS_CHUNK = 512  # sequence-chunked CE: per-chunk logits only (memory cap)


def _chunk_ce(params, x_c, labels_c, cfg):
    """CE sums for one token chunk; checkpointed, so its logits are transient.

    The gold logit is a ``gather``; the reference contracts a one-hot (to
    keep the vocab axis shardable under GSPMD) and gets the same value."""
    with torch.profiler.record_function("chunked_ce"):
        logits = _logits(params, x_c, cfg)                     # (B, sc, V) f32
        mask = (labels_c >= 0).float()
        if isinstance(logits, DTensor):
            lse, gold = _sharded_lse_gold(logits, labels_c)
        else:
            lse = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(-1, labels_c.clamp_min(0).long()[..., None])[..., 0]
        ce_sum = ((lse - gold) * mask).sum()
        z_sum = (lse * mask).square().sum()
        return ce_sum, z_sum, mask.sum()


def _sharded_lse_gold(logits, labels):
    """Log-sum-exp and gold logit of DTensor logits whose vocab dim may be
    sharded, with no gather of the logits: the row max, the sum of
    exponentials and the gold logit (each rank picks the ids in its vocab
    shard) reduce over the vocab shards as (B, S) all-reduces, and stay
    replicated there, with their gradients, so that the backward's
    softmax meets the logits' own layout.  DTensor's own ``logsumexp`` and
    ``gather`` would all-gather the logits; left to itself it also
    reduce-scatters the rows over the vocab's mesh dims, and the backward
    then gathers logits-sized tensors to meet them."""
    mesh, l_pl = logits.device_mesh, list(logits.placements)
    vocab = logits.ndim - 1
    idx, n = shard_offset(mesh, l_pl, vocab)
    row_pl = [Replicate() if isinstance(a, Shard) and a.dim == vocab else a for a in l_pl]
    if n == 1:       # the vocab whole on each rank: the one-device formula
        lse = torch.logsumexp(logits, dim=-1)
    else:
        m = relayout(logits.detach().amax(dim=-1, keepdim=True), row_pl)
        lse = relayout((logits - m).exp().sum(dim=-1), row_pl).log() + m[..., 0]
    labels = labels.clamp_min(0).long()
    lab_pl = [a if isinstance(a, Shard) and a.dim < vocab else Replicate() for a in l_pl]
    out_pl = [Partial() if isinstance(a, Shard) and a.dim == vocab else b
              for a, b in zip(l_pl, lab_pl)]

    def local(lg, lab):
        lab = lab - idx * lg.shape[-1]
        mine = (lab >= 0) & (lab < lg.shape[-1])
        g = lg.gather(-1, lab.clamp(0, lg.shape[-1] - 1)[..., None])[..., 0]
        return g * mine

    gold = local_map(local, out_placements=out_pl, in_placements=(l_pl, lab_pl),
                     device_mesh=mesh, redistribute_inputs=True)(logits, labels)
    return lse, relayout(gold, row_pl)


def loss_fn(params, batch, cfg):
    """Next-token CE + z-loss (+ the MoE aux losses). labels: (B, S) int,
    -1 = masked.

    The unembedding + CE is sequence-chunked (each chunk of ``LOSS_CHUNK``
    tokens checkpointed): the (B, S, V) logits are never alive at once, at
    the cost of one more logits product in the backward.  Returns
    ``(total, metrics)``; the metrics are detached 0-dim tensors with the
    reference's keys."""
    x, aux = _train_stack(params, batch, cfg)
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
    """A zero cache; for the audio family with the cross-attention K/V of
    zero frames (the reference's abstract path; the prefill step gives
    the encoder's)."""
    require_ported(cfg)
    device = params["emb"].device
    if cfg.enc_dec:
        return encdec.init_encdec_cache(params, cfg, batch, max_len)
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
    if cfg.enc_dec:
        x_t, cache = encdec.decoder_decode(params["dec_layers"], x_t, cache, pos, cfg)
    elif cfg.family == "hybrid":
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
    warm-up); so does this.  The audio family raises, as in the
    reference: its prefill is the encoder pass of the serve step."""
    require_ported(cfg)
    if cfg.enc_dec:
        raise NotImplementedError("enc-dec prefill is the encoder pass; see "
                                  "runtime/steps.py: make_prefill_step")
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
