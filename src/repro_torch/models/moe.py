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

Under a mesh (the sharded steps) the tokens are sharded as ``act_batch``
and the routed experts as the reference lays them out: expert-sharded on
"model" (EP) where ``n_routed % 16 == 0``, else split along their hidden
dim (TP-of-experts).  DTensor has no sharding rule for the dispatch's
data-dependent ops, so they run on local shards in ``local_map``:

- each shard counts its (token, expert) pairs per expert, and the counts
  of every shard are all-gathered (E integers a shard); a pair's slot is
  the pairs of its expert on earlier shards plus its place among its own
  shard's, which is its place in the reference's global stable sort, so
  the capacity, the drops and ``moe_drop_frac`` are the one-device step's;
- each shard writes its own tokens into the slots of the experts it holds,
  a ``Partial`` buffer over the token-sharding mesh dims that the
  reference's first ``constrain`` reduces (each slot has one writer, so the
  sum is exact);
- the combine reads each local pair's slot from the expert outputs and
  sums over K, a ``Partial`` sum over "model" (the reference's all-reduce
  over "model") reduced at the layer's residual ``constrain``.

:func:`moe_decode` on a mesh takes the reference's own route
(each token's K expert matrices gathered from the local experts, then
products), on local shards.  On a mesh of one rank
nothing is sharded and the grouped route runs on the local tensors, so the
step equals the one-device step bit for bit; a dry run's fake tensors
cannot be read on the host, and there the gather route is traced, whose
products cost the same 6 B K M F flops a layer.
"""
from __future__ import annotations

import math
import struct

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.models.layers import dense_init, pdtype
from repro_torch.models.mlp import init_swiglu, swiglu_apply
from repro_torch.sharding import active_mesh, constrain
from repro_torch.sharding.specs import placements_for, relayout, shard_offset


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


def expert_counts(flat_ids: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Pairs a routed expert, int64 (E,): ``bincount`` of a fixed length,
    as a scatter-add, whose shape a fake tensor knows."""
    return torch.zeros(n_experts, dtype=torch.int64, device=flat_ids.device).scatter_add_(
        0, flat_ids, torch.ones_like(flat_ids))


def load_balance_loss(probs: torch.Tensor, ids: torch.Tensor, n_experts: int,
                      counts: torch.Tensor | None = None) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e mean_assign_e * mean_prob_e;
    ``counts`` (E,) are the pairs a routed expert, counted from ``ids``
    where not given."""
    T, K = ids.shape
    if counts is None:
        counts = expert_counts(ids.reshape(-1), n_experts)
    f = counts.float() / T / K
    return n_experts * torch.sum(f * probs.mean(0))


def capacity(cfg, T: int) -> int:
    """Slots an expert has for ``T`` tokens: never more than ``T``."""
    m = cfg.moe
    return min(int(math.ceil(T * m.top_k / m.n_routed * m.capacity_factor)), T)


def dispatch(ids: torch.Tensor, n_experts: int, cap: int, prefix: torch.Tensor | None = None):
    """The reference's slot assignment of the flat (token, expert) pairs of
    ``ids`` (T, K): ``order`` (a stable argsort of the flat ids), the
    sorted ids, each sorted pair's slot ``dst`` in its expert's buffer
    (``cap``, the spare row, where it is dropped) and the ``keep`` mask.
    ``prefix`` (E,): the pairs of each expert that come before these in
    the global order (earlier token shards), whose slots come first."""
    flat_ids = ids.reshape(-1)                                   # (T*K,)
    order = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[order]
    counts = expert_counts(flat_ids, n_experts)
    starts = counts.cumsum(0) - counts
    if prefix is not None:
        starts = starts - prefix
    pos_in_e = torch.arange(flat_ids.numel(), device=ids.device) - starts[sorted_ids]
    keep = pos_in_e < cap
    return order, sorted_ids, torch.where(keep, pos_in_e, cap), keep


def _drop_frac(kept: torch.Tensor, n: int) -> torch.Tensor:
    """``1 - mean(keep)`` of ``kept`` slots out of ``n`` as the reference's
    jitted step computes it: the kept count times the f32 reciprocal of the
    slot count, subtracted from 1 with one rounding to f32 (exact in f64
    first), so that the fraction equals the reference's to the last bit."""
    inv_n = struct.unpack("f", struct.pack("f", 1.0 / n))[0]
    return (1.0 - kept.double() * inv_n).float()


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
    mesh = active_mesh()
    sharded = mesh is not None and isinstance(x, DTensor)
    xf = x.reshape(T, M)
    if sharded:
        tok_pl = placements_for(("act_batch", None), (T, M), mesh)
        xf = relayout(xf, tok_pl)

    logits = xf.float() @ p["router"]                            # (T, E)
    probs, weights, ids = router_topk(logits, K)
    cap = capacity(cfg, T)
    if sharded:
        counts = _shard_counts(ids, E, mesh, tok_pl)             # (token shards, E)
        total = counts.sum(0)
        aux = {"moe_aux": load_balance_loss(probs, ids, E, total) * m.aux_coef,
               "moe_drop_frac": _drop_frac(total.clamp_max(cap).sum(), T * K)}
    else:
        aux = {"moe_aux": load_balance_loss(probs, ids, E) * m.aux_coef}
    aux["moe_z"] = torch.logsumexp(logits, dim=-1).square().mean() * m.router_z_coef

    # ---- sort-based dispatch ------------------------------------------------
    # EP when the expert count divides the model axis; TP-of-experts otherwise
    ep = E % 16 == 0
    if sharded:
        buf, combine = _mesh_dispatch(xf, ids, counts, cap, E, K, ep, mesh, tok_pl)
    else:
        order, sorted_ids, dst, keep = dispatch(ids, E, cap)
        aux["moe_drop_frac"] = _drop_frac(keep.sum(), keep.numel())
        buf = _fill(xf, order, sorted_ids, dst, E, cap, K)
    buf = constrain(buf, ("act_expert", None, None) if ep else (None, None, None))

    # ---- expert FFN, batched over experts -----------------------------------
    h = F.silu(torch.bmm(buf, p["experts_wg"])) * torch.bmm(buf, p["experts_wu"])
    h = constrain(h, ("act_expert", None, None) if ep else (None, None, "act_mlp"))
    out_slots = torch.bmm(h, p["experts_wd"])                    # (E, cap, M)

    # ---- weighted combine, in token order, summed over K in f32 --------------
    if sharded:
        y = combine(out_slots, weights)
    else:
        y = _combine(out_slots, weights, order, sorted_ids, dst, keep, K, x.dtype)

    out = y.reshape(B, S, M)
    if "shared" in p:
        out = out + swiglu_apply(p["shared"], x)
    return out, aux


def _fill(xf, order, rows, dst, n_rows: int, cap: int, K: int):
    """The (n_rows, cap, M) slot buffer: sorted pair i's token into slot
    ``dst[i]`` of expert row ``rows[i]``; ``dst == cap`` writes a spare
    row that is sliced off."""
    buf = xf.new_zeros((n_rows, cap + 1, xf.shape[-1]))
    buf[rows, dst] = xf[order // K]
    return buf[:, :cap]


def _combine(out_slots, weights, order, rows, dst, keep, K: int, dtype):
    """Each sorted pair's slot output times its weight (0 where ``keep``
    is false), put back in token order and summed over K in f32."""
    cap, M = out_slots.shape[1:]
    w_sorted = weights.reshape(-1)[order] * keep
    vals = out_slots[rows, dst.clamp_max(cap - 1)].float() * w_sorted[:, None]
    by_token = torch.empty_like(vals)
    by_token[order] = vals
    return by_token.reshape(-1, K, M).sum(1).to(dtype)


def _shard_counts(ids, n_experts: int, mesh, tok_pl):
    """Every token shard's pairs per expert, (shards, E) int64 replicated:
    each shard counts its own, then one all-gather."""
    counts = local_map(lambda i: expert_counts(i.reshape(-1), n_experts)[None],
                       out_placements=tok_pl, in_placements=(tok_pl,), device_mesh=mesh,
                       redistribute_inputs=True)(ids)
    return counts.redistribute(mesh, [Replicate()] * mesh.ndim)


def _mesh_dispatch(xf, ids, counts, cap: int, E: int, K: int, ep: bool, mesh, tok_pl):
    """The slot buffer of a mesh (see the module docstring) and the combine
    that goes with it: ``(buf, combine(out_slots, weights) -> y (T, M))``.
    ``buf`` is ``Partial`` over the token-sharding mesh dims and, under EP,
    holds this rank's experts (sharded as ``act_expert``)."""
    rep = [Replicate()] * mesh.ndim
    e_pl = placements_for(("act_expert", None, None), (E, cap, 1), mesh) if ep else rep
    tok_dims = [i for i, a in enumerate(tok_pl) if isinstance(a, Shard)]
    e_dims = [i for i, a in enumerate(e_pl) if isinstance(a, Shard)]
    assert not set(tok_dims) & set(e_dims), (tok_pl, e_pl)
    b_idx, _ = shard_offset(mesh, tok_pl, 0)
    e_idx, n_e = shard_offset(mesh, e_pl, 0)
    E_l = E // n_e
    e0 = e_idx * E_l
    buf_pl = [Partial() if i in tok_dims else a for i, a in enumerate(e_pl)]
    x_grad = [Partial() if i in e_dims else a for i, a in enumerate(tok_pl)]
    plan = {}

    def fill(xl, idl, cnt):
        order, sorted_ids, dst, keep = dispatch(idl, E, cap, prefix=cnt[:b_idx].sum(0))
        if n_e > 1:   # pairs of experts on other ranks go to the spare row
            keep = keep & (sorted_ids >= e0) & (sorted_ids < e0 + E_l)
            dst = torch.where(keep, dst, cap)
            sorted_ids = torch.where(keep, sorted_ids - e0, 0)
        plan.update(order=order, rows=sorted_ids, dst=dst, keep=keep)
        return _fill(xl, order, sorted_ids, dst, E_l, cap, K)

    buf = local_map(fill, out_placements=buf_pl, in_placements=(tok_pl, tok_pl, rep),
                    in_grad_placements=(x_grad, tok_pl, rep), device_mesh=mesh,
                    redistribute_inputs=True)(xf, ids, counts)

    def combine(out_slots, weights):
        # the outputs of every slot on each token shard; a Partial sum over
        # "model" (TP-of-experts) stays one, and so does the combine
        o_pl = [Partial() if isinstance(a, Partial) and i not in tok_dims else
                (e_pl[i] if i in e_dims else Replicate())
                for i, a in enumerate(out_slots.placements)]
        partial = [i in e_dims or isinstance(o_pl[i], Partial) for i in range(mesh.ndim)]
        y_pl = [Partial() if partial[i] else a for i, a in enumerate(tok_pl)]
        o_grad = [Partial() if i in tok_dims else (e_pl[i] if i in e_dims else Replicate())
                  for i in range(mesh.ndim)]
        w_grad = [Partial() if partial[i] else a for i, a in enumerate(tok_pl)]
        return local_map(
            lambda o, w: _combine(o, w, plan["order"], plan["rows"], plan["dst"], plan["keep"],
                                  K, xf.dtype),
            out_placements=y_pl, in_placements=(o_pl, tok_pl), in_grad_placements=(o_grad, w_grad),
            device_mesh=mesh, redistribute_inputs=True)(out_slots, weights)

    return buf, combine


def moe_decode(p: dict, x_t: torch.Tensor, cfg) -> torch.Tensor:
    """Decode path.  x_t: (B, M) -> (B, M); every token through its K
    experts, grouped by expert (see the module's docstring).  Marked
    ``moe`` for the profiler."""
    with torch.profiler.record_function("moe"):
        return _moe_decode(p, x_t, cfg)


def _moe_decode(p: dict, x_t: torch.Tensor, cfg) -> torch.Tensor:
    m = cfg.moe
    logits = x_t.float() @ p["router"]
    _, weights, ids = router_topk(logits, m.top_k)               # (B, K)
    experts = (p["experts_wg"], p["experts_wu"], p["experts_wd"])
    mesh = active_mesh()
    if mesh is not None and isinstance(x_t, DTensor):
        out = _mesh_decode(x_t, weights, ids, experts, m.n_routed, mesh)
    else:
        out = _grouped(x_t, weights, ids, *experts)
    if "shared" in p:
        out = out + swiglu_apply(p["shared"], x_t)
    return out


def _grouped(x_t, weights, ids, wg, wu, wd):
    """The routed experts' output (B, M), grouped by expert: the expert
    counts are read on the host (``bincount`` on CUDA first reads its
    input's min and max), inside a profiler range ``moe.host_sync``."""
    B, M = x_t.shape
    K = ids.shape[1]
    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    with torch.profiler.record_function("moe.host_sync"):
        counts = torch.bincount(flat, minlength=wg.shape[0]).tolist()
    xs = x_t[order // K]                                         # (B*K, M), by expert
    ys = torch.empty_like(xs)
    start = 0
    for e, c in enumerate(counts):
        if c:
            xe = xs[start:start + c]
            h = F.silu(xe @ wg[e]) * (xe @ wu[e])
            torch.matmul(h, wd[e], out=ys[start:start + c])
            start += c
    by_pair = torch.empty_like(ys)
    by_pair[order] = ys
    return (by_pair.reshape(B, K, M).float() * weights[..., None]).sum(1).to(x_t.dtype)


def _gathered(x_t, weights, ids, wg, wu, wd, e0: int = 0):
    """The routed experts' output (B, M) by the reference's route: each
    token's K expert matrices gathered, then products.  ``wg`` ... hold
    experts ``e0 ..`` only: a pair of another expert adds nothing."""
    mine = (ids >= e0) & (ids < e0 + wg.shape[0])
    j = torch.where(mine, ids - e0, 0)
    g = F.silu(torch.einsum("bm,bkmf->bkf", x_t, wg[j]))
    u = torch.einsum("bm,bkmf->bkf", x_t, wu[j])
    y = torch.einsum("bkf,bkfm->bkm", g * u, wd[j])
    return (y.float() * (weights * mine)[..., None]).sum(1).to(x_t.dtype)


def _mesh_decode(x_t, weights, ids, experts, E: int, mesh):
    """The routed experts on local shards: the experts' own layout kept on
    their expert dim and hidden dim (EP or TP-of-experts), their model dim
    gathered (FSDP); a ``Partial`` sum over the mesh dims that shard them."""
    x_pl = placements_for(("act_batch", None), x_t.shape, mesh)
    hidden = (2, 2, 1)             # the hidden dim of wg, wu (E, M, F) and wd (E, F, M)
    w_pls = [[a if isinstance(a, Shard) and a.dim in (0, h) else Replicate()
              for a in w.placements] for w, h in zip(experts, hidden)]
    e_idx, n_e = shard_offset(mesh, w_pls[0], 0)
    e0 = e_idx * (E // n_e)
    y_pl = [Partial() if isinstance(a, Shard) else b for a, b in zip(w_pls[0], x_pl)]
    one = mesh.size() == 1

    def local(x, w, i, wg, wu, wd):
        if one and not isinstance(x, FakeTensor):
            return _grouped(x, w, i, wg, wu, wd)
        return _gathered(x, w, i, wg, wu, wd, e0)

    return local_map(local, out_placements=y_pl, in_placements=(x_pl, x_pl, x_pl, *w_pls),
                     device_mesh=mesh, redistribute_inputs=True)(x_t, weights, ids, *experts)
