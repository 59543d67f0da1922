"""Mixture-of-experts block: shared experts + routed top-k experts.

Port of ``repro/models/moe.py``.  :func:`moe_apply` keeps the reference's
sort-based dispatch exactly: f32 router, top-k, a stable argsort of the
flat expert ids, each expert's slots filled in that order up to the
capacity ``min(ceil(T * K / E * capacity_factor), T)``, and the slots past
it dropped.  So the kept mask, the expert ids and ``moe_drop_frac`` equal
the reference's.  Two differences of form, not of function:

- the reference scatters with ``mode="drop"``; here a dropped slot is
  written to a spare row of the buffer that is sliced off (an
  out-of-range index on the card is a device-side assert);
- the reference scatter-adds each token's K weighted contributions in the
  model dtype; here they are put back in token order as (T, K, M) and
  summed over K in f32, cast once (an atomic ``index_add_`` would make the
  sum's order, and so a bf16 result, differ from run to run).

:func:`moe_decode` computes the reference's function (every token through
its K experts, nothing dropped) without its per-token gather of expert
matrices, which copies (B, K, M, F) weights a layer: the B * K (token,
expert) pairs are grouped by expert and each chosen expert runs once on
its tokens, reading its weights in place.  Which experts were chosen is
read on the host, one sync a layer.
"""
from __future__ import annotations

import math
import struct

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, pdtype
from repro_torch.models.mlp import init_swiglu, swiglu_apply
from repro_torch.sharding import constrain


def init_moe(generator, cfg, layers: int | None = None, device="cuda") -> dict:
    """Router (f32) and expert stacks (E, M, F) / (E, F, M), drawn one
    expert matrix at a time; with ``layers``, stacked on a leading axis."""
    m = cfg.moe
    dt = pdtype(cfg)
    M, Fd, E = cfg.d_model, m.d_expert, m.n_routed
    lead = () if layers is None else (layers,)
    p = {
        "router": dense_init(generator, (M, E), torch.float32, layers=layers, device=device),
        "experts_wg": dense_init(generator, (M, Fd), dt, layers=(*lead, E), device=device),
        "experts_wu": dense_init(generator, (M, Fd), dt, layers=(*lead, E), device=device),
        "experts_wd": dense_init(generator, (Fd, M), dt, layers=(*lead, E), device=device),
    }
    if m.n_shared > 0:
        p["shared"] = init_swiglu(generator, cfg, layers, device, d_ff=m.n_shared * Fd)
    return p


def router_topk(logits: torch.Tensor, k: int):
    """Top-k routing with normalized combine weights.  logits (T, E) f32."""
    probs = torch.softmax(logits, dim=-1)
    weights, ids = torch.topk(probs, k, dim=-1)                 # (T, K)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    return probs, weights, ids


def load_balance_loss(probs: torch.Tensor, ids: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e mean_assign_e * mean_prob_e."""
    T, K = ids.shape
    f = torch.bincount(ids.reshape(-1), minlength=n_experts).float() / T / K
    return n_experts * torch.sum(f * probs.mean(0))


def capacity(cfg, T: int) -> int:
    """Slots an expert has for ``T`` tokens: never more than ``T``."""
    m = cfg.moe
    return min(int(math.ceil(T * m.top_k / m.n_routed * m.capacity_factor)), T)


def dispatch(ids: torch.Tensor, n_experts: int, cap: int):
    """The reference's slot assignment of the flat (token, expert) pairs of
    ``ids`` (T, K): ``order`` (a stable argsort of the flat ids), the
    sorted ids, each sorted pair's slot ``dst`` in its expert's buffer
    (``cap``, the spare row, where it is dropped) and the ``keep`` mask."""
    flat_ids = ids.reshape(-1)                                   # (T*K,)
    order = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[order]
    counts = torch.bincount(flat_ids, minlength=n_experts)
    starts = counts.cumsum(0) - counts
    pos_in_e = torch.arange(flat_ids.numel(), device=ids.device) - starts[sorted_ids]
    keep = pos_in_e < cap
    return order, sorted_ids, torch.where(keep, pos_in_e, cap), keep


def _drop_frac(keep: torch.Tensor) -> torch.Tensor:
    """``1 - mean(keep)`` as the reference's jitted step computes it: the
    kept count times the f32 reciprocal of the slot count, subtracted from
    1 with one rounding to f32 (exact in f64 first), so that the fraction
    equals the reference's to the last bit."""
    inv_n = struct.unpack("f", struct.pack("f", 1.0 / keep.numel()))[0]
    return (1.0 - keep.sum(dtype=torch.float64) * inv_n).float()


def moe_apply(p: dict, x: torch.Tensor, cfg):
    """x: (B, S, M) -> (out, aux); aux holds the router losses and the
    fraction of (token, expert) slots dropped.  Marked ``moe`` for the
    profiler."""
    with torch.profiler.record_function("moe"):
        return _moe_apply(p, x, cfg)


def _moe_apply(p: dict, x: torch.Tensor, cfg):
    m = cfg.moe
    B, S, M = x.shape
    T, E, K = B * S, m.n_routed, m.top_k
    xf = x.reshape(T, M)

    logits = xf.float() @ p["router"]                            # (T, E)
    probs, weights, ids = router_topk(logits, K)
    aux = {"moe_aux": load_balance_loss(probs, ids, E) * m.aux_coef,
           "moe_z": torch.logsumexp(logits, dim=-1).square().mean() * m.router_z_coef}

    # ---- sort-based dispatch ------------------------------------------------
    cap = capacity(cfg, T)
    order, sorted_ids, dst, keep = dispatch(ids, E, cap)
    buf = x.new_zeros((E, cap + 1, M))
    buf[sorted_ids, dst] = xf[order // K]                        # row cap: the spare row
    buf = buf[:, :cap]
    # EP when the expert count divides the model axis; TP-of-experts otherwise
    ep = E % 16 == 0
    buf = constrain(buf, ("act_expert", None, None) if ep else (None, None, None))

    # ---- expert FFN, batched over experts -----------------------------------
    h = F.silu(torch.bmm(buf, p["experts_wg"])) * torch.bmm(buf, p["experts_wu"])
    h = constrain(h, ("act_expert", None, None) if ep else (None, None, "act_mlp"))
    out_slots = torch.bmm(h, p["experts_wd"])                    # (E, cap, M)

    # ---- weighted combine, in token order, summed over K in f32 --------------
    w_sorted = weights.reshape(-1)[order] * keep
    vals = out_slots[sorted_ids, dst.clamp_max(cap - 1)].float() * w_sorted[:, None]
    by_token = torch.empty_like(vals)
    by_token[order] = vals
    y = by_token.reshape(T, K, M).sum(1).to(x.dtype)

    aux["moe_drop_frac"] = _drop_frac(keep)
    out = y.reshape(B, S, M)
    if "shared" in p:
        out = out + swiglu_apply(p["shared"], x)
    return out, aux


def moe_decode(p: dict, x_t: torch.Tensor, cfg) -> torch.Tensor:
    """Decode path.  x_t: (B, M) -> (B, M); every token through its K
    experts, grouped by expert (see the module's docstring).  Marked
    ``moe`` for the profiler."""
    with torch.profiler.record_function("moe"):
        return _moe_decode(p, x_t, cfg)


def _moe_decode(p: dict, x_t: torch.Tensor, cfg) -> torch.Tensor:
    m = cfg.moe
    B, M = x_t.shape
    K = m.top_k
    logits = x_t.float() @ p["router"]
    _, weights, ids = router_topk(logits, K)                     # (B, K)

    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=m.n_routed).tolist()   # the host sync
    xs = x_t[order // K]                                         # (B*K, M), by expert
    ys = torch.empty_like(xs)
    start = 0
    for e, c in enumerate(counts):
        if c:
            xe = xs[start:start + c]
            h = F.silu(xe @ p["experts_wg"][e]) * (xe @ p["experts_wu"][e])
            torch.matmul(h, p["experts_wd"][e], out=ys[start:start + c])
            start += c
    by_pair = torch.empty_like(ys)
    by_pair[order] = ys
    out = (by_pair.reshape(B, K, M).float() * weights[..., None]).sum(1).to(x_t.dtype)
    if "shared" in p:
        out = out + swiglu_apply(p["shared"], x_t)
    return out
