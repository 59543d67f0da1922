"""Per-step cost terms that the job profiles are built from.

Port of ``repro/launch/roofline.py``: the per-chip constants of the
simulated TPU v5e pod the co-scheduling agent was trained against, the
roofline terms, and the analytic FLOP, HBM-byte and collective-byte counts
of one model step.  The constants are inputs of the reference performance
model, not measurements of the GPU the port runs on: schedule parity with
the reference depends on keeping them.

The reference reads a step's per-chip costs from its compiled HLO
(``cost_analysis``, ``fusion_adjusted_bytes``, ``parse_collectives``).
The port has no HLO: :class:`CostCounter` reads the ops a step runs, one
rank's local ops (DTensor ops are let through to their local work):

- **flops**: ``2 m n k`` of every matrix product (``mm``, ``addmm``,
  ``bmm``, ``baddbmm``, ``mv``) on its local shapes, plus the kernels'
  formulas.  Elementwise work is not counted.
- **bytes**: operand + result bytes of the ops in :data:`MAJOR_OPS` (the
  torch ops that stand for the reference's ``_MAJOR_OPS``: products,
  gathers, scatters, sorts, reductions, concatenation, copies, the
  collectives) plus the kernels' formulas; ``bytes_raw`` counts every op
  that is not a view.  XLA fuses where eager torch does not, so neither
  figure is expected to equal the reference's.
- **collectives**: the ``_c10d_functional`` ops, by result bytes, with
  the reference's weights and names (:func:`collective_stats`).
- **memory**: bytes of the storages the step allocates, alive at once
  (``peak``), above the ones that existed when it began.

The kernels launch through ``ctypes`` on data pointers, out of a dispatch
mode's sight, and their plain versions' block loops are not the kernel's
work: each kernel wrapper reports its own flops and bytes through
:func:`kernel_call` and runs with counting paused.  The flash kernel counts
``4 B Hq D`` a visible (query, key) pair; decode counts every cache slot,
``4 B Hq Smax D`` (its valid lengths are device values a counter must not
wait for, and fake tensors have none: the reference's cost analysis also
counts its dense decode attention over the whole cache).  DTensor's own
sharding propagation runs ops on global fake tensors; they are skipped.
A loop whose trips cost the same runs its first trip once on fake tensors
and counts it once a trip (:class:`TracedLoop`, :func:`repeat`).
"""
from __future__ import annotations

import contextlib
import os
import sys
import weakref
from dataclasses import dataclass, field

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

# --- simulated TPU v5e pod, per chip (performance-model inputs) ------------
PEAK_FLOPS = 197e12          # bf16 FLOP/s
HBM_BW = 819e9               # bytes/s
ICI_LINK_BW = 50e9           # bytes/s per link
ICI_LINKS_PER_AXIS = 2       # bidirectional ring on one mesh axis
ICI_BW = ICI_LINK_BW * ICI_LINKS_PER_AXIS
HBM_BYTES = 16 * 1024**3     # 16 GiB HBM per chip

_COLLECTIVE_WEIGHT = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


@dataclass
class CollectiveStats:
    bytes_weighted: float = 0.0
    bytes_raw: float = 0.0
    count: int = 0
    by_op: dict = field(default_factory=dict)


def roofline_terms(flops_per_chip: float, bytes_per_chip: float,
                   coll_bytes_weighted: float) -> dict:
    ct = flops_per_chip / PEAK_FLOPS
    mt = bytes_per_chip / HBM_BW
    xt = coll_bytes_weighted / ICI_BW
    dominant = max(("compute", ct), ("memory", mt), ("collective", xt), key=lambda kv: kv[1])
    total = max(ct, mt, xt)
    return {
        "compute_term_s": ct,
        "memory_term_s": mt,
        "collective_term_s": xt,
        "dominant": dominant[0],
        "step_time_lb_s": total,  # overlap roofline: max of the three
    }


# ---------------------------------------------------------------------------
# Counters over the ops a step runs (the HLO parsers' stand-ins)
# ---------------------------------------------------------------------------

# torch collective -> the reference's HLO opcode
COLLECTIVE_NAMES = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def collective_stats(records) -> CollectiveStats:
    """A :class:`CollectiveStats` of ``(torch name, result bytes)`` records
    (:attr:`CostCounter.collectives` holds them), weighted as the
    reference weighs HLO collectives (all-reduce x2)."""
    stats = CollectiveStats()
    for name, b, *_ in records:
        op = COLLECTIVE_NAMES[name]
        stats.bytes_raw += b
        stats.bytes_weighted += b * _COLLECTIVE_WEIGHT[op]
        stats.count += 1
        agg = stats.by_op.setdefault(op, {"bytes": 0.0, "count": 0})
        agg["bytes"] += b
        agg["count"] += 1
    return stats


_aten = torch.ops.aten
# The ops whose operands and results cross HBM, standing for the
# reference's ``_MAJOR_OPS`` (dot, convolution, gather, scatter, sort,
# reduce, dynamic-(update-)slice, concatenate, copy, collectives; fusions
# and custom calls are the kernels, counted by their formulas).
MAJOR_OPS = frozenset(getattr(_aten, n) for n in (
    "mm", "addmm", "bmm", "baddbmm", "mv", "convolution",                    # dot, convolution
    "gather", "index", "index_select", "embedding", "take_along_dim",       # gather
    "scatter", "scatter_add", "scatter_add_", "index_put", "index_put_",    # scatter
    "_index_put_impl_", "index_add", "index_add_", "embedding_dense_backward",
    "sort", "topk", "argsort",                                               # sort
    "sum", "mean", "amax", "amin", "max", "min", "logsumexp", "linalg_vector_norm",  # reduce
    "var", "prod", "cumsum", "cummax", "bincount", "argmax", "argmin", "any", "all",
    "cat", "stack", "slice_scatter", "select_scatter",                       # concatenate, dus
    "copy", "copy_", "clone", "_to_copy",                                    # copy
))


def _mm_flops(func, args, out) -> float:
    p = func._overloadpacket
    if p in (_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm):
        a = args[0] if p in (_aten.mm, _aten.bmm) else args[1]
        return 2.0 * out.numel() * a.shape[-1]
    if p is _aten.mv:
        return 2.0 * args[0].numel()
    return 0.0


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for t in x:
            yield from _tensors(t)


_PROP_FILE = os.path.join("tensor", "_sharding_prop.py")


def _in_sharding_prop() -> bool:
    """Whether the op runs inside DTensor's sharding propagation (its
    output-shape inference on global fake tensors, no rank's work)."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith(_PROP_FILE):
            return True
        f = f.f_back
    return False


_ACTIVE: list = []


class CostCounter(TorchDispatchMode):
    """Per-chip flops, bytes, collectives and memory of the ops run under
    it (see the module docstring).  ``existing`` holds tensors whose
    storages are there before the step (its arguments): they, their views
    and in-place writes to them allocate nothing."""

    def __init__(self, existing=()):
        super().__init__()
        self.flops = self.bytes = self.bytes_raw = 0.0
        self.collectives: list[tuple[str, int, str]] = []   # (name, result bytes, group)
        self.kernels: dict[str, list[float]] = {}           # name -> [calls, flops, bytes]
        self.live = self.peak = 0
        self._seen = weakref.WeakKeyDictionary()
        self._paused = 0
        self._times = 1          # trips of a loop body traced once (:func:`repeat`)
        for t in existing:
            self._seen[t.untyped_storage()] = True

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def track(self, out) -> None:
        """Count the storages of ``out`` that are new as allocations."""
        for t in _tensors(out):
            if isinstance(t, DTensor):
                t = t._local_tensor
            s = t.untyped_storage()
            if s in self._seen:
                continue
            n = s.nbytes()
            self._seen[s] = True
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(s, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def retain(self, tensors, extra: int, new_only: bool = False) -> None:
        """Count the storages of ``tensors`` ``extra`` more times as live
        until they die: the copies a loop traced once keeps, one a trip.
        ``new_only``: skip the storages this counter has seen (arguments,
        and allocations it counted)."""
        for t in _tensors(tensors):
            if new_only and t.untyped_storage() in self._seen:
                continue
            n = extra * t.untyped_storage().nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(t.untyped_storage(), self._free, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented        # DTensor runs its local ops under this mode
        out = func(*args, **kwargs)
        if self._paused or _in_sharding_prop():
            return out
        n = self._times
        if func.namespace == "_c10d_functional":
            name = func._overloadpacket.__name__
            if name in COLLECTIVE_NAMES:
                b = _nbytes(out)
                group = args[-1] if isinstance(args[-1], str) else ""
                self.collectives.extend([(name, b, group)] * n)
                self.bytes += n * (b + _nbytes(args[0]))
            self.track(out)
            return out
        if func.namespace == "prim" or func.is_view:
            return out
        b = n * (_nbytes(args) + _nbytes(list(kwargs.values())) + _nbytes(out))
        self.bytes_raw += b
        if func._overloadpacket in MAJOR_OPS:
            self.bytes += b
        self.flops += n * _mm_flops(func, args, out)
        self.track(out)
        return out

    def add_kernel(self, name: str, flops: float, nbytes: float) -> None:
        k = self.kernels.setdefault(name, [0, 0.0, 0.0])
        k[0] += 1
        k[1] += flops
        k[2] += nbytes
        self.flops += flops
        self.bytes += nbytes
        self.bytes_raw += nbytes

    def stats(self) -> CollectiveStats:
        return collective_stats(self.collectives)


@contextlib.contextmanager
def repeat(n: int):
    """Count the ops run inside ``n`` times each in every active
    :class:`CostCounter` (a loop body traced once for its ``n`` trips)."""
    counters = list(_ACTIVE)
    for c in counters:
        c._times *= n
    try:
        yield
    finally:
        for c in counters:
            c._times //= n


@contextlib.contextmanager
def paused():
    """Count none of the ops run inside, in every active :class:`CostCounter`."""
    counters = list(_ACTIVE)
    for c in counters:
        c._paused += 1
    try:
        yield
    finally:
        for c in counters:
            c._paused -= 1


def retain(tensors, extra: int, new_only: bool = False) -> None:
    """:meth:`CostCounter.retain` in every active counter."""
    for c in _ACTIVE:
        c.retain(tensors, extra, new_only)


def _trips(x: torch.Tensor, dim: int, size: int) -> int:
    return x.shape[dim] if size == 0 else x.shape[dim] // size


def _first(x: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    return x.select(dim, 0) if size == 0 else x.narrow(dim, 0, size)


def _join(y: torch.Tensor, n: int, dim: int, size: int) -> torch.Tensor:
    return torch.stack([y] * n, dim) if size == 0 else torch.cat([y] * n, dim)


class TracedLoop(torch.autograd.Function):
    """A loop whose trips cost the same, on a dry run's fake tensors (some
    0.3 ms of host time an op): the first trip is traced and counted once
    a trip (:func:`repeat`), forward and backward, and the tensors a trip
    keeps are counted live once a trip (:func:`retain`).

    ``apply(step, carry_fn, dim, size, n_xs, *xs, *ws)``: the loop cuts
    each of the ``n_xs`` tensors ``xs`` into trips along ``dim``
    (``unbind`` where ``size`` is 0, else ``split(size)``) and runs
    ``step(carry, *x_trip, *ws) -> (carry, y)`` from ``carry_fn(False)``;
    the result is the trips' ``y`` stacked (or concatenated) along ``dim``.
    Its backward counts the first trip's backward once without the
    carry's gradient, which nothing asks for there, and for the other
    trips with it (``carry_fn(True)`` makes a carry of distinct tensors).
    The stacks of the outputs and of the inputs' gradients are the loop's
    own ops, so flops and the bytes of major ops equal the loop's; raw
    bytes (the weights' gradient sums) and live bytes are near."""

    @staticmethod
    def forward(ctx, step, carry_fn, dim, size, n_xs, *tensors):
        xs, ws = tensors[:n_xs], tensors[n_xs:]
        n = _trips(xs[0], dim, size)
        ctx.save_for_backward(*tensors)
        ctx.loop = (step, carry_fn, dim, size, n_xs, n)
        carry = carry_fn(False)
        with repeat(n):
            y = step(carry, *(_first(x, dim, size) for x in xs), *ws)[1]
        retain(y, n - 1)
        return _join(y, n, dim, size)

    @staticmethod
    def backward(ctx, g):
        step, carry_fn, dim, size, n_xs, n = ctx.loop
        tensors = ctx.saved_tensors
        g1 = _first(g, dim, size)
        grads = _trip_backward(step, carry_fn, tensors, n_xs, dim, size, g1, n - 1, True)
        _trip_backward(step, carry_fn, tensors, n_xs, dim, size, g1, 1, False)
        return (None,) * 5 + tuple(_join(gx, n, dim, size) for gx in grads[:n_xs]) + tuple(
            grads[n_xs:])


def _trip_backward(step, carry_fn, tensors, n_xs, dim, size, g_y, trips: int,
                   carry_grad: bool) -> tuple:
    """One trip's backward counted ``trips`` times: its forward rerun
    uncounted (a loop's backward reruns none), the tensors it saves
    counted live ``trips`` times.  The gradients of the trip's inputs and
    of the weights."""
    saved = []

    def pack(t):
        saved.append(t)
        return t

    with torch.enable_grad(), paused(), torch.autograd.graph.saved_tensors_hooks(pack,
                                                                                 lambda t: t):
        inputs = [(_first(t, dim, size) if i < n_xs else t).detach().requires_grad_()
                  for i, t in enumerate(tensors)]
        carry = carry_fn(True)
        for t in carry if carry_grad else ():
            t.requires_grad_()
        new_carry, y = step(carry, *inputs)
        grad_outs = [torch.zeros_like(t) for t in new_carry] + [g_y]
    retain(saved, trips, new_only=True)
    with repeat(trips):
        grads = torch.autograd.grad([*new_carry, y], inputs + (list(carry) if carry_grad else []),
                                    grad_outs)
    return grads[:len(inputs)]


def kernel_call(name: str, cost, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, a kernel launch or its plain version, with
    its formula ``cost() -> (flops, bytes)`` added to every active
    :class:`CostCounter` in place of the ops it runs (and not evaluated
    when none is)."""
    if not _ACTIVE:
        return fn(*args, **kwargs)
    counters = list(_ACTIVE)
    flops, nbytes = cost()
    for c in counters:
        c.add_kernel(name, flops, nbytes)
    with paused():
        out = fn(*args, **kwargs)
    for c in counters:
        c.track(out)
    return out


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
