"""Analytic per-step cost terms that the job profiles are built from.

A copy of the parts of ``repro/launch/roofline.py`` that
``core/profiles.py`` needs: the per-chip constants of the simulated TPU v5e
pod the co-scheduling agent was trained against, and the analytic FLOP,
HBM-byte and collective-byte counts of one model step.  The constants are
inputs of the reference performance model, not measurements of the GPU the
port runs on: schedule parity with the reference depends on keeping them.
"""
from __future__ import annotations

# --- simulated TPU v5e pod, per chip (performance-model inputs) ------------
PEAK_FLOPS = 197e12          # bf16 FLOP/s
HBM_BW = 819e9               # bytes/s
ICI_LINK_BW = 50e9           # bytes/s per link
ICI_LINKS_PER_AXIS = 2       # bidirectional ring on one mesh axis
ICI_BW = ICI_LINK_BW * ICI_LINKS_PER_AXIS


# ---------------------------------------------------------------------------
# Analytic MODEL_FLOPS (useful work) per cell — 6ND convention
# ---------------------------------------------------------------------------

def model_flops(cfg, shape) -> float:
    """6*N_active*D for train (3x fwd), 2*N_active per token for inference,
    plus the attention quadratic term; embeddings excluded from N."""
    n_active = cfg.n_active_params()
    emb = cfg.vocab_size * cfg.d_model
    n_body = n_active - emb - (0 if cfg.tie_embeddings else emb)
    logits_per_tok = 2 * cfg.vocab_size * cfg.d_model

    # attention layers
    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // cfg.attn_every
    elif cfg.family == "ssm":
        n_attn = 0
    elif cfg.enc_dec:
        n_attn = cfg.n_enc_layers + 2 * cfg.n_layers
    else:
        n_attn = cfg.n_layers

    B, S = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        tokens = B * S
        # causal fwd attn flops per layer: 2 * B * S^2 * Hq * Dh  (qk + pv, /2 causal)
        attn_fwd = 2.0 * B * S * S * cfg.n_heads * cfg.d_head * n_attn
        mult = 3.0 if shape.kind == "train" else 1.0
        body = 2.0 * n_body * tokens * mult
        logits = logits_per_tok * tokens * (mult if shape.kind == "train" else 1.0)
        return body + logits + attn_fwd * mult
    # decode: one token per sequence against an S-long cache
    tokens = B
    attn = 4.0 * B * S * cfg.n_kv_heads * cfg.d_head * n_attn  # qk + pv over cache
    return 2.0 * n_active * tokens + logits_per_tok * tokens + attn


def _n_attn_layers(cfg) -> int:
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    if cfg.family == "ssm":
        return 0
    if cfg.enc_dec:
        return cfg.n_layers
    return cfg.n_layers


def model_bytes_min(cfg, shape) -> float:
    """Realistic minimum HBM traffic per step (fused-TPU assumption).

    train:   params bf16 fwd+bwd reads + grad write + optimizer state r/w
             (~30 B/param) + activation streams: ~10 (B,S,M)-sized tensors
             per layer per pass x 3 passes (fwd, remat re-fwd, bwd).
    prefill: params once + 10-tensor activation stream x 1 pass.
    decode:  active params once + KV/state cache read + MoE expert reads.
    """
    n_active = cfg.n_active_params()
    tokens = shape.global_batch * shape.seq_len
    layers = max(1, cfg.n_layers + (cfg.n_enc_layers if cfg.enc_dec else 0))
    act_stream = 10.0 * 2.0 * cfg.d_model * layers  # bytes per token per pass

    if shape.kind == "train":
        pbytes = 30.0 * n_active
        return pbytes + 3.0 * act_stream * tokens
    if shape.kind == "prefill":
        return 2.0 * n_active + act_stream * tokens
    # decode
    B, S = shape.global_batch, shape.seq_len
    pbytes = 2.0 * n_active
    kv = 2.0 * B * S * cfg.n_kv_heads * cfg.d_head * _n_attn_layers(cfg) * 2
    moe = 0.0
    if cfg.moe is not None:
        m = cfg.moe
        touched = min(m.n_routed, B * m.top_k)
        moe = (cfg.n_layers // m.every) * touched * 3.0 * cfg.d_model * m.d_expert * 2
        pbytes = 2.0 * (n_active - cfg.n_active_params() + n_active)  # keep params term
    if cfg.family in ("hybrid", "ssm"):
        # recurrent state r/w per step
        if cfg.mamba is not None:
            d_in = cfg.mamba.expand * cfg.d_model
            n_mamba = cfg.n_layers - _n_attn_layers(cfg)
            kv += 2.0 * B * d_in * cfg.mamba.d_state * 4 * n_mamba
        if cfg.xlstm is not None:
            dh = int(cfg.xlstm.expand_m * cfg.d_model) // cfg.n_heads
            kv += 2.0 * B * cfg.n_heads * dh * dh * 4 * (cfg.n_layers // 2)
    return pbytes + kv + moe


def model_coll_bytes_chip(cfg, shape, chips: int = 256, tp: int = 16) -> float:
    """Analytic per-chip weighted collective bytes per step under the baseline
    TP(model axis) x FSDP(data axis) rules — used when no dry-run record backs
    a profile. Matches the measured structure: per-layer activation
    all-reduces (x2 ring weight) + FSDP param all-gather/grad reduce-scatter."""
    dp = max(1, chips // tp)
    tokens = shape.global_batch * shape.seq_len
    layers = max(1, cfg.n_layers + (cfg.n_enc_layers if cfg.enc_dec else 0))
    if shape.kind == "train":
        act = tokens // dp * cfg.d_model * 2            # one (B/dp, S, M) bf16
        ar = 4.0 * layers * act * 2.0                   # 2 fwd + 2 bwd ARs, ring x2
        fsdp = 3.0 * 2.0 * cfg.n_active_params() / tp   # AG fwd+bwd + RS grads (bf16)
        return ar + fsdp
    if shape.kind == "prefill":
        act = tokens // dp * cfg.d_model * 2
        return 2.0 * layers * act * 2.0
    # decode: tiny activations, per-layer AR of (B, M)
    act = shape.global_batch * cfg.d_model * 2
    return 2.0 * layers * act * 2.0
