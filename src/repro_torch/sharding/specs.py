"""Logical-axis sharding rules (MaxText-style) -> DTensor placements.

Port of ``repro/sharding/specs.py``.  Model code never names mesh axes
directly; it annotates tensors with *logical* axes ("act_batch", "tp",
"fsdp", ...).  A rules table maps logical axes onto mesh axes, and mesh
axes that do not exist on the active mesh are dropped — the same model
code therefore runs on the single-pod ("data", "model") mesh, the
multi-pod ("pod", "data", "model") mesh, scheduler sub-slice meshes, and
the 1x1 mesh of one card.

A spec is the reference's ``PartitionSpec`` as a plain tuple: one entry a
tensor dim, each ``None``, a mesh-axis name or a tuple of names.
:class:`NamedSharding` turns it into DTensor placements, one a mesh dim:
``Shard(d)`` where the dim's axis sits at tensor dim ``d``, else
``Replicate()``; a tuple entry such as ``("data", "model")`` shards dim
``d`` over both mesh dims, in mesh order (a tuple in another order raises:
DTensor cannot express it, and no rule table produces it).  Where a
spec names one mesh axis at two tensor dims (``SEQ_PARALLEL_RULES`` puts
``act_seq`` and ``act_heads`` both on "model"), the first dim keeps it;
``jax.sharding.NamedSharding`` refuses such a spec.

Hillclimbing perf = swapping the rules table, not editing the model.
"""
from __future__ import annotations

import contextlib
import math
import re
from dataclasses import dataclass
from typing import Any, Mapping, Sequence

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

AxisRules = Mapping[str, Any]  # logical axis -> mesh axis | tuple | None

# ---------------------------------------------------------------------------
# Rule tables
# ---------------------------------------------------------------------------

# Paper-faithful / baseline rules: TP on "model", FSDP (param+opt sharding) on
# "data", batch DP over ("pod", "data").
DEFAULT_RULES: AxisRules = {
    # parameter axes
    "fsdp": "data",            # ZeRO/FSDP dim of every weight
    "fsdp_e": "data",          # FSDP dim of expert weights (never overlaps ep)
    "tp": "model",             # tensor-parallel dim of every weight
    "ep": "model",             # expert-parallel dim (routed experts)
    "vocab_tp": "model",
    # activation axes
    "act_batch": ("pod", "data"),
    "act_seq": None,
    "act_embed": None,
    "act_heads": "model",
    "act_kv_heads": "model",
    "act_mlp": "model",
    "act_vocab": "model",
    "act_expert": "model",
    "act_state": None,
    "act_seq_cache": None,       # decode KV-cache sequence dim
}

# Megatron-SP-style variant: activations sequence-sharded on "model" between
# blocks (all-gather in, reduce-scatter out). Enabled via ModelConfig.seq_parallel.
# act_vocab must come off "model" (logits chunks are seq-sharded there).
SEQ_PARALLEL_RULES: AxisRules = dict(DEFAULT_RULES, act_seq="model", act_vocab=None)

# FSDP+SP variant (hillclimb): no tensor parallelism — weights fully sharded
# over BOTH mesh axes (pure ZeRO-3), activations batch-sharded over "data"
# and sequence-sharded over "model". Replaces the per-layer O(B*S*M)
# activation all-reduces of TP with per-layer O(params) all-gathers.
FSDP_SP_RULES: AxisRules = {
    **DEFAULT_RULES,
    "tp": None,
    "fsdp": ("data", "model"),
    "fsdp_e": "data",            # expert dim keeps "model" for ep
    "act_heads": None,
    "act_kv_heads": None,
    "act_mlp": None,
    "act_expert": "model",
    "act_seq": "model",
    "act_seq_cache": "model",    # decode caches sequence-sharded too
    "act_vocab": None,           # logits seq-sharded instead (seq is on "model")
}

# ---------------------------------------------------------------------------
# Active mesh/rules context
# ---------------------------------------------------------------------------

# A module-level stack, where the reference keeps a context variable: the
# autograd engine runs a CUDA backward, and with it a checkpoint's
# recomputed forward, on a thread of its own, which sees none of the
# caller's context variables.
_STACK: list[tuple[Any, AxisRules]] = [(None, DEFAULT_RULES)]


@contextlib.contextmanager
def use_mesh_rules(mesh, rules: AxisRules = DEFAULT_RULES):
    _STACK.append((mesh, dict(rules)))
    try:
        yield
    finally:
        _STACK.pop()


def active_mesh():
    return _STACK[-1][0]


def current_rules() -> AxisRules:
    return _STACK[-1][1]


# ---------------------------------------------------------------------------
# Spec construction
# ---------------------------------------------------------------------------

def _axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _resolve(axis: Any, mesh, rules: AxisRules):
    """Map one logical axis to mesh axes present on `mesh` (or None)."""
    if axis is None:
        return None
    mapped = rules.get(axis, None) if isinstance(axis, str) else axis
    if mapped is None:
        return None
    names = mesh.mesh_dim_names
    if isinstance(mapped, str):
        return mapped if mapped in names else None
    # tuple of mesh axes: keep the ones this mesh has
    kept = tuple(a for a in mapped if a in names)
    return kept if kept else None


def logical_spec(axes: Sequence[Any], mesh=None, rules: AxisRules | None = None) -> tuple:
    mesh = mesh or active_mesh()
    rules = rules or current_rules()
    if mesh is None:
        return ()
    return tuple(_resolve(a, mesh, rules) for a in axes)


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _divisible(spec: tuple, shape: Sequence[int], mesh) -> tuple:
    """``spec`` with every dim that its mesh axes do not divide replicated."""
    size = _axis_sizes(mesh)
    return tuple(None if i < len(shape) and shape[i] % math.prod(size[a] for a in
                                                                  _entry_axes(e)) else e
                 for i, e in enumerate(spec))


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh; :attr:`placements` are its DTensor placements."""

    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        names = list(self.mesh.mesh_dim_names)
        out: list = [Replicate()] * len(names)
        for d, entry in enumerate(self.spec):
            idx = [names.index(a) for a in _entry_axes(entry)]
            if idx != sorted(idx):
                raise ValueError(f"spec entry {entry!r}: mesh axes out of the mesh's order "
                                 f"{tuple(names)}")
            for i in idx:
                if isinstance(out[i], Replicate):   # a mesh axis shards one dim: the first
                    out[i] = Shard(d)
        return tuple(out)

    def shard_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        """Local shape of one shard of a ``shape`` tensor (dims must divide)."""
        n = [1] * len(shape)
        for i, p in zip(self.mesh.shape, self.placements):
            if isinstance(p, Shard):
                n[p.dim] *= i
        for dim, k in zip(shape, n):
            if dim % k:
                raise ValueError(f"shape {tuple(shape)} does not divide over {self.spec}")
        return tuple(dim // k for dim, k in zip(shape, n))


def named_sharding(axes: Sequence[Any], mesh=None, rules: AxisRules | None = None) -> NamedSharding:
    mesh = mesh or active_mesh()
    assert mesh is not None, "named_sharding requires an active mesh"
    return NamedSharding(mesh, logical_spec(axes, mesh, rules))


def placements_for(axes: Sequence[Any], shape: Sequence[int], mesh=None,
                   rules: AxisRules | None = None) -> list:
    """DTensor placements of a ``shape`` tensor with logical ``axes`` (a dim
    its mesh axes do not divide stays replicated), as the list
    ``local_map`` takes."""
    mesh = mesh or active_mesh()
    return list(NamedSharding(mesh, _divisible(logical_spec(axes, mesh, rules), shape,
                                               mesh)).placements)


def shard_offset(mesh, placements: Sequence, dim: int) -> tuple[int, int]:
    """``(index, count)``: this rank's shard of tensor dim ``dim`` among
    the ``count`` equal shards ``placements`` cut it into."""
    coord = mesh.get_coordinate()
    idx, n = 0, 1
    for i, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == dim:
            idx, n = idx * mesh.shape[i] + coord[i], n * mesh.shape[i]
    return idx, n


class _CotangentLike(torch.autograd.Function):
    """Identity whose backward lays the gradient out as the forward value
    (a ``Partial`` gradient is reduced there), as the transpose of XLA's
    sharding constraint constrains the cotangent."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, x.placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, ctx.placements)


def constrain(x: torch.Tensor, axes: Sequence[Any]) -> torch.Tensor:
    """Redistribute ``x`` to its logical axes' placements (the reference's
    ``with_sharding_constraint``): a ``Partial`` sum becomes an all-reduce or
    a reduce-scatter, a shard moves by all-to-all or all-gather; its
    gradient is laid out the same way.  (Left alone, DTensor carries a
    ``Partial`` gradient on into the next product, which then runs unsharded
    on every rank.)  A no-op without an active mesh or on a mesh of one
    rank; a dim its mesh axes do not divide stays replicated; a plain
    tensor counts as replicated."""
    mesh = active_mesh()
    if mesh is None or mesh.size() == 1:
        return x
    spec = _divisible(logical_spec(axes, mesh), x.shape, mesh)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return relayout(x, NamedSharding(mesh, spec).placements)


def on_batch_shards(fn, *xs: torch.Tensor, whole: Sequence[int] = (), n_out: int = 1):
    """``fn(*xs)`` on each rank's shard of the batch, for a computation
    that treats each batch row alone: dim 0 of each argument sharded as
    ``act_batch``, every other dim whole, and the ``n_out`` outputs laid
    out the same.  The arguments at ``whole`` have no batch dim and are
    replicated (their gradients ``Partial`` sums over the batch's mesh
    dims).  Without an active mesh, or on plain tensors, ``fn(*xs)``."""
    mesh = active_mesh()
    if mesh is None or not any(isinstance(x, DTensor) for x in xs):
        return fn(*xs)
    rep = [Replicate()] * mesh.ndim
    b = next(x for i, x in enumerate(xs) if i not in whole).shape[0]
    pl = list(NamedSharding(mesh, _divisible(logical_spec(("act_batch",), mesh), (b,),
                                             mesh)).placements)
    grad = [Partial() if isinstance(a, Shard) else a for a in pl]
    xs = [x if isinstance(x, DTensor) else DTensor.from_local(x, mesh, rep, run_check=False)
          for x in xs]
    return local_map(fn, out_placements=pl if n_out == 1 else (pl,) * n_out,
                     in_placements=tuple(rep if i in whole else pl for i in range(len(xs))),
                     in_grad_placements=tuple(grad if i in whole else pl
                                              for i in range(len(xs))),
                     device_mesh=mesh, redistribute_inputs=True)(*xs)


def relayout(x: DTensor, placements: Sequence) -> DTensor:
    """``x`` redistributed to ``placements``, and its gradient laid out the
    same way in the backward."""
    x = x.redistribute(x.device_mesh, placements)
    return _CotangentLike.apply(x) if x.requires_grad else x


# ---------------------------------------------------------------------------
# Parameter spec tree (path-pattern rules)
# ---------------------------------------------------------------------------

# Pattern -> logical axes for the *trailing* dims of the parameter.  Scanned
# stacks (leading layer dim) get None prepended automatically.  First match
# wins; order matters.
#
# GQA note: when n_kv_heads < n_heads (TP degree exceeds kv heads), the K/V
# projections are *replicated* on the model axis (Megatron GQA strategy):
# redundant tiny kv-proj compute instead of a replicate+repartition collective
# per layer.
_PARAM_RULES_KV_REPLICATED: list[tuple[str, tuple[Any, ...]]] = [
    (r"(wk|wv)$", ("fsdp", None)),
    (r"(bk|bv)$", (None,)),
]

# TP-of-experts fallback when n_routed is not divisible by the model axis
# (e.g. qwen2-moe's 60 experts on a 16-wide axis): shard the expert FFN dim
# instead of the expert dim.
_PARAM_RULES_EXPERT_TP: list[tuple[str, tuple[Any, ...]]] = [
    (r"experts_(wg|wu)$", (None, "fsdp", "tp")),
    (r"experts_wd$", (None, "tp", "fsdp")),
]

_PARAM_RULES: list[tuple[str, tuple[Any, ...]]] = [
    # MoE routed experts: (E, d_in, d_out)
    (r"experts_(wg|wu)$", ("ep", "fsdp_e", None)),
    (r"experts_wd$", ("ep", None, "fsdp_e")),
    (r"router$", ("fsdp", None)),
    # embedding / unembedding: vocab-sharded ONLY (a d_model dim on "data"
    # would put the logits product's contraction on the batch axis)
    (r"(^|/)emb$", ("vocab_tp", None)),
    (r"lm_head$", (None, "vocab_tp")),
    # attention / general projections: in -> out(tp)
    (r"(wq|wk|wv|wqkv|wg|wu|w_in|w_up|w_i|w_gates)$", ("fsdp", "tp")),
    (r"(wo|wd|w_out|w_down)$", ("tp", "fsdp")),
    (r"(bq|bk|bv|bqkv|b_in|b_up)$", ("tp",)),
    # mamba internals (d_inner is the tp-sharded dim)
    (r"conv_w$", (None, "tp")),
    (r"conv_b$", ("tp",)),
    (r"w_x$", ("tp", None)),
    (r"w_dt$", (None, "tp")),
    (r"b_dt$", ("tp",)),
    (r"A_log$", ("tp", None)),
    (r"(^|/)D$", ("tp",)),
    # sLSTM recurrent weights are tiny -> replicate
    (r"slstm_", ()),
    # norms, small biases, gates: replicate
    (r".*", ()),
]


def _spec_for_path(path: str, ndim: int, scanned: bool, replicate_kv: bool = False,
                   ep_experts: bool = True) -> tuple[Any, ...]:
    rules = list(_PARAM_RULES)
    if replicate_kv:
        rules = _PARAM_RULES_KV_REPLICATED + rules
    if not ep_experts:
        rules = _PARAM_RULES_EXPERT_TP + rules
    for pat, axes in rules:
        if re.search(pat, path):
            base = list(axes)
            break
    else:  # pragma: no cover
        base = []
    want = ndim - (1 if scanned else 0)
    # pad/trim to the parameter's trailing rank
    if len(base) > want:
        base = base[-want:] if want > 0 else []
    while len(base) < want:
        base.insert(0, None)
    if scanned:
        base.insert(0, None)  # stacked layer dim: never sharded
    return tuple(base)


_SCAN_KEYS = ("layers", "blocks", "enc_layers", "dec_layers", "pairs")


def _map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over a nested dict (or list), paths joined by "/"."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, f"{path}/{i}" if path else str(i))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _ndim(leaf) -> int:
    return leaf.ndim if hasattr(leaf, "ndim") else len(leaf) if isinstance(leaf, tuple) else 0


def build_param_specs(params: Any, replicate_kv: bool = False,
                      ep_experts: bool = True) -> Any:
    """Tree of *logical axis tuples* matching ``params`` (tensors or shape
    tuples); resolve with :func:`specs_to_shardings` against a mesh.
    ``replicate_kv``: GQA kv-projection replication; ``ep_experts=False``:
    TP-of-experts fallback for expert counts not divisible by the model axis.
    """

    def leaf_spec(s, leaf):
        scanned = any(f"{k}/" in s or s.startswith(f"{k}/") for k in _SCAN_KEYS)
        return _spec_for_path(s, _ndim(leaf), scanned, replicate_kv, ep_experts)

    return _map_with_path(leaf_spec, params)


def _map_specs(fn, logical_tree, abstract_tree=None):
    if isinstance(logical_tree, dict):
        return {k: _map_specs(fn, v, None if abstract_tree is None else abstract_tree[k])
                for k, v in logical_tree.items()}
    return fn(logical_tree, abstract_tree)


def specs_to_shardings(logical_tree: Any, mesh, rules: AxisRules | None = None,
                       abstract_tree: Any = None) -> Any:
    """Resolve a logical-axes tree (a nested dict of tuples, or one tuple)
    into :class:`NamedSharding`s for a mesh.

    With ``abstract_tree`` (tensors of the same tree: ``meta`` or real), any
    dimension whose size is not divisible by its resolved mesh-axes product
    is dropped to replicated — the production-safe fallback for odd
    head/gate/expert counts and batch-1 decode cells."""
    rules = rules or DEFAULT_RULES

    def resolve(axes, leaf):
        spec = logical_spec(axes, mesh, rules)
        if leaf is not None and hasattr(leaf, "shape"):
            spec = _divisible(spec, tuple(leaf.shape), mesh)
        return NamedSharding(mesh, spec)

    return _map_specs(resolve, logical_tree, abstract_tree)


# ---------------------------------------------------------------------------
# Inference-cache spec tree (path-pattern rules, trailing-dim aligned)
# ---------------------------------------------------------------------------

_CACHE_RULES: list[tuple[str, tuple[Any, ...]]] = [
    (r"cross/len$", ("act_batch",)),
    (r"(^|/)(k|v)$", ("act_batch", "act_seq_cache", "act_kv_heads", None)),
    (r"mamba/h$", ("act_batch", "tp", None)),
    (r"mamba/conv$", ("act_batch", None, "tp")),
    (r"mlstm/C$", ("act_batch", "act_heads", None, None)),
    (r"mlstm/n$", ("act_batch", "act_heads", None)),
    (r"mlstm/m$", ("act_batch", "act_heads")),
    (r"mlstm/conv$", ("act_batch", None, "tp")),
    (r"slstm/", ("act_batch", None, None)),
    (r".*", ("act_batch",)),
]


def build_cache_specs(cache: Any, replicate_kv: bool = False) -> Any:
    """Logical-axes tree for an inference cache (leading stack dims -> None).

    ``replicate_kv``: GQA caches keep heads replicated (batch-sharded only),
    matching the replicated kv projections."""

    def leaf_spec(s, leaf):
        for pat, axes in _CACHE_RULES:
            if re.search(pat, s):
                base = list(axes)
                if replicate_kv and re.search(r"(^|/)(k|v)$", s):
                    base = ["act_batch", "act_seq_cache", None, None]
                break
        ndim = _ndim(leaf)
        if len(base) > ndim:
            base = base[-ndim:] if ndim else []
        while len(base) < ndim:
            base.insert(0, None)
        return tuple(base)

    return _map_with_path(leaf_spec, cache)
