"""The yardstick's arithmetic: the H100's peaks, a kernel's least time,
and the operations and bytes that a step's shapes need.

Frozen here so that a change to the program cannot change what it is
measured against.  The peaks are NVIDIA's data sheet for the H100 SXM
(dense, no sparsity) at its full power limit of 700 W; the exp unit's rate
is 132 SMs x 16 ex2 a clock x 1.83 GHz, the clock at which 989 TFLOP/s is
132 x 4,096 flops a clock.
"""
from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
EXP_PER_S = 132 * 16 * 1.83e9
ESIZE = {"bfloat16": 2, "float32": 4}


def bound_s(byts: float, ops: float, dtype: str, exps: float = 0.0) -> float:
    """The least time of a piece of work: the largest of its bytes over the
    memory rate, its operations over the peak of their type and its
    exponentials (one ``ex2`` each) over the exp unit's rate."""
    return max(byts / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype], exps / EXP_PER_S)


def visible_pairs(sq: int, skv: int, causal: bool) -> int:
    """(query, key) pairs a right-aligned causal mask lets through: query i
    sits at position ``i + skv - sq``."""
    if not causal:
        return sq * skv

    def f(n):   # sum over j = 1..n of min(j, skv)
        if n <= 0:
            return 0
        m = min(n, skv)
        return m * (m + 1) // 2 + (n - m) * skv

    return f(skv) - f(skv - sq)


def flash_bound_s(b: int, sq: int, skv: int, hq: int, hkv: int, d: int, causal: bool,
                  dtype: str) -> float:
    """One flash forward launch: 4 D operations a visible pair and q head,
    one ex2 a visible pair and q head; q, k, v read once, the output
    written once."""
    pairs = b * hq * visible_pairs(sq, skv, causal)
    e = ESIZE[dtype]
    byts = e * d * (2 * b * sq * hq + 2 * b * skv * hkv)
    return bound_s(byts, 4.0 * d * pairs, dtype, exps=float(pairs))


def decode_bound_s(lengths, hq: int, hkv: int, d: int, dtype: str) -> float:
    """One decode attention launch over rows of valid ``lengths``: q read
    and the output written once, each valid key and value read once, the
    lengths read once; 4 D operations a valid key and q head."""
    e = ESIZE[dtype]
    b, rows = len(lengths), sum(int(n) for n in lengths)
    byts = 2 * b * hq * d * e + 2 * rows * hkv * d * e + 4 * b
    return bound_s(byts, 4.0 * rows * hq * d, dtype)


# ---------------------------------------------------------------------------
# Model operations a step needs (multiply-adds count two)
# ---------------------------------------------------------------------------

def _attn_proj(c: dict) -> int:
    """q, k, v and o projections, a token."""
    m, q, kv = c["d_model"], c["n_heads"] * c["d_head"], c["n_kv_heads"] * c["d_head"]
    return 2 * (2 * m * q + 2 * m * kv)


def _ffn(c: dict) -> int:
    """The MLP of a token: GELU (2 matrices) for the encoder-decoder,
    SwiGLU (3) for a dense decoder; a MoE layer's router, its top-k routed
    experts and its shared experts."""
    m = c["d_model"]
    moe = c.get("moe")
    if moe:
        f = moe["d_expert"]
        return 2 * m * moe["n_routed"] + moe["top_k"] * 6 * m * f + 6 * m * moe["n_shared"] * f
    if c.get("enc_dec"):
        return 4 * m * c["d_ff"]
    return 6 * m * c["d_ff"]


def _attn_core(c: dict, pairs: int) -> int:
    """QK^T and PV over ``pairs`` (query, key) pairs, every q head."""
    return 4 * c["n_heads"] * c["d_head"] * pairs


def encoder_prefill_flops(c: dict, batch: int, frames: int) -> float:
    """The encoder-decoder's prefill step: every encoder layer over
    ``batch`` x ``frames`` (non-causal attention), then each decoder
    layer's cross-attention K and V of the encoder's output."""
    t = batch * frames
    kv = c["n_kv_heads"] * c["d_head"]
    enc = c["n_enc_layers"] * (t * (_attn_proj(c) + _ffn(c))
                               + _attn_core(c, batch * frames * frames))
    return float(enc + c["n_layers"] * t * 2 * 2 * c["d_model"] * kv)


def lm_prefill_flops(c: dict, batch: int, tokens: int) -> float:
    """A decoder-only prefill of ``batch`` x ``tokens`` (causal), with the
    logits of each sequence's last position."""
    t = batch * tokens
    per_layer = t * (_attn_proj(c) + _ffn(c)) + _attn_core(
        c, batch * visible_pairs(tokens, tokens, True))
    return float(c["n_layers"] * per_layer + batch * 2 * c["d_model"] * c["vocab_size"])


def decode_flops(c: dict, lengths, enc_lens=None) -> float:
    """One decode step of ``len(lengths)`` sequences, row ``b`` attending
    over ``lengths[b]`` keys (the new one included); the encoder-decoder
    adds a cross-attention over ``enc_lens[b]`` frames and its q and o
    projections.  Each row's logits over the whole vocabulary."""
    b = len(lengths)
    m = c["d_model"]
    per_layer = b * (_attn_proj(c) + _ffn(c)) + _attn_core(c, sum(int(n) for n in lengths))
    if c.get("enc_dec"):
        q = c["n_heads"] * c["d_head"]
        per_layer += b * 2 * 2 * m * q + _attn_core(c, sum(int(n) for n in enc_lens))
    return float(c["n_layers"] * per_layer + b * 2 * m * c["vocab_size"])
