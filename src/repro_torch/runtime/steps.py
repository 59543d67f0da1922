"""Train and serve step factories, on one device or on a mesh.

Port of ``repro/runtime/steps.py``.  The reference jits each step with the
``NamedSharding`` trees of a mesh and donates the state: the train step
its params and optimizer state, the decode step its cache.  Here a step is
a callable, and the donation is the in-place update (AdamW writes the
params, master weights and moments in place; decode writes its cache row
in place).  :func:`abstract_state` and :func:`batch_specs` give the
abstract trees as tensors on the ``meta`` device (shapes and dtypes,
nothing allocated).

With ``mesh`` (a ``DeviceMesh`` of ``("data", "model")`` or ``("pod",
"data", "model")``), a step takes its state as DTensors laid out by
:func:`state_shardings` / :func:`cache_shardings` (:func:`distribute`
cuts them from full tensors that every rank holds alike, collective-free),
shards its batch by the ``act_batch`` rule, and runs the model under
``use_mesh_rules`` and ``implicit_replication``: the tensors the model
makes itself (positions, RoPE tables, masks, the zero aux) are plain
tensors that count as replicated, which costs no collective.  A mesh of
one rank is the one-device step through DTensors.  ``mesh=None`` is the
one-device step.

- :func:`make_train_step`: ``loss_fn``'s value and gradients by autograd,
  then ``adamw_update``; one step of every family (the audio family's
  batch adds ``frames``).
- :func:`make_prefill_step`, :func:`make_decode_step`: over
  :func:`repro_torch.models.model.prefill` and ``decode_step``; the
  encoder-decoder's prefill step is the encoder pass and the
  cross-attention K/V.  Each call of a serve step is a profiler range,
  ``step.prefill`` or ``step.decode``.
"""
from __future__ import annotations

import functools

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.models import encdec
from repro_torch.models.layers import pdtype, rmsnorm
from repro_torch.models.model import (
    decode_step, init_cache, init_params, loss_fn, prefill, require_ported,
)
from repro_torch.optim import (
    OptConfig, adamw_update, init_opt_state, tree_leaves, tree_unflatten,
)
from repro_torch.sharding import (
    DEFAULT_RULES, SEQ_PARALLEL_RULES, build_cache_specs, build_param_specs, named_sharding,
    specs_to_shardings, use_mesh_rules,
)
from repro_torch.sharding.specs import shard_offset

MODEL_AXIS_SIZE = 16  # model-axis width of both production meshes


def _rules_for(cfg, rules=None):
    if rules is not None:
        return rules
    return SEQ_PARALLEL_RULES if cfg.seq_parallel else DEFAULT_RULES


def _ep_ok(cfg) -> bool:
    return cfg.moe is None or cfg.moe.n_routed % MODEL_AXIS_SIZE == 0


def _span(name: str):
    """A step run inside a profiler range ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return spanned
    return wrap


def _check(what: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if tuple(t.shape) != shape or t.device.type != device.type:
        raise ValueError(f"{what}: got {tuple(t.shape)} on {t.device}, the step takes {shape} "
                         f"on {device}")


# ---------------------------------------------------------------------------
# Abstract state and the train step
# ---------------------------------------------------------------------------

def abstract_state(cfg, with_opt: bool = True):
    """``(params, opt_state)`` as ``meta`` tensors of the shapes and dtypes
    ``init_params`` and ``init_opt_state`` give (the reference's
    ``eval_shape``); ``opt_state`` is None without ``with_opt``."""
    params = init_params(cfg, device="meta")
    return params, (init_opt_state(params) if with_opt else None)


def state_shardings(cfg, mesh, rules=None, with_opt: bool = True):
    """``(params, param shardings, opt_state, opt shardings)``: the abstract
    state and a :class:`~repro_torch.sharding.specs.NamedSharding` a leaf
    (the optimizer's master, m and v as the params; ``count`` replicated).
    Without ``with_opt`` the last two are None."""
    rules = _rules_for(cfg, rules)
    params, opt = abstract_state(cfg, with_opt)
    pspecs = build_param_specs(params, replicate_kv=cfg.n_kv_heads < cfg.n_heads,
                               ep_experts=_ep_ok(cfg))
    psh = specs_to_shardings(pspecs, mesh, rules, abstract_tree=params)
    if not with_opt:
        return params, psh, None, None
    osh = {"master": psh, "m": psh, "v": psh, "count": named_sharding((), mesh, rules)}
    return params, psh, opt, osh


def batch_specs(cfg, shape, mesh=None, rules=None):
    """The abstract training batch of a ``ShapeConfig``, as ``meta``
    tensors: ``tokens`` and ``labels`` (B, S) int32; the audio family adds
    ``frames`` (B, min(enc_len, S), d_model) in the model's dtype.  With a
    mesh, ``(batch, shardings)`` as the reference returns them."""
    B, S = shape.global_batch, shape.seq_len
    batch = {k: torch.empty((B, S), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    if cfg.enc_dec:
        batch["frames"] = torch.empty((B, min(cfg.enc_len, S), cfg.d_model), dtype=pdtype(cfg),
                                      device="meta")
    if mesh is None:
        return batch
    return batch, batch_specs_like(cfg, mesh, rules)[1]


def batch_specs_like(cfg, mesh, rules=None):
    """``(None, shardings)`` of a batch of any shape."""
    rules = _rules_for(cfg, rules)
    sh = {k: named_sharding(("act_batch", None), mesh, rules) for k in ("tokens", "labels")}
    if cfg.enc_dec:
        sh["frames"] = named_sharding(("act_batch", None, None), mesh, rules)
    return None, sh


def train_input_specs(cfg, shape, mesh, rules=None):
    """All abstract inputs + shardings for train_step (dry-run entry)."""
    params, psh, opt, osh = state_shardings(cfg, mesh, rules)
    batch, bsh = batch_specs(cfg, shape, mesh, rules)
    return {"params": params, "opt_state": opt, "batch": batch}, \
           {"params": psh, "opt_state": osh, "batch": bsh}


def cache_shardings(cfg, mesh, batch: int, max_len: int, rules=None):
    """``(abstract cache, shardings)`` of a ``batch`` x ``max_len`` cache."""
    rules = _rules_for(cfg, rules)
    params, _ = abstract_state(cfg, with_opt=False)
    cache = init_cache(params, cfg, batch, max_len)
    cspecs = build_cache_specs(cache, replicate_kv=cfg.n_kv_heads < cfg.n_heads)
    return cache, specs_to_shardings(cspecs, mesh, rules, abstract_tree=cache)


def local_shard(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's block of a full tensor ``t`` under ``placements`` on
    ``mesh`` (a view where nothing is cut)."""
    for d in range(t.ndim):
        idx, n = shard_offset(mesh, placements, d)
        if t.shape[d] % n:
            raise ValueError(f"dim {d} of a {tuple(t.shape)} tensor does not divide into {n} "
                             f"shards ({placements})")
        if n > 1:
            size = t.shape[d] // n
            t = t.narrow(d, idx * size, size).contiguous()
    return t


def shard(t: torch.Tensor, sharding) -> torch.Tensor:
    """This rank's shard of a full tensor ``t`` (every rank holds it
    alike) as a DTensor of ``sharding``; no collective, and no copy where
    nothing is cut.  A DTensor passes through."""
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(local_shard(t, sharding.mesh, sharding.placements),
                              sharding.mesh, sharding.placements, run_check=False)


def distribute(tree, shardings):
    """:func:`shard` over a tree of full tensors and its shardings tree
    (``opt_state``'s 0-dim ``count`` stays a plain tensor)."""
    if isinstance(tree, dict):
        return {k: distribute(v, shardings[k]) for k, v in tree.items()}
    return tree if tree.ndim == 0 else shard(tree, shardings)


def full(t):
    """The global tensor of a DTensor (a collective every rank must join);
    a plain tensor as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def train_step(params, opt, batch, cfg, opt_cfg: OptConfig):
    """One step: ``(params, opt, metrics)``, params and optimizer state
    updated in place.  ``params``' leaves are set to require grad;
    ``metrics`` holds the loss's metrics, ``grad_norm`` and ``lr`` as 0-dim
    tensors (reading them waits for the device)."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    with torch.enable_grad():
        total, metrics = loss_fn(params, batch, cfg)
        grads = tree_unflatten(params, torch.autograd.grad(total, leaves))
    del total
    with torch.profiler.record_function("adamw"):
        params, opt, om = adamw_update(params, grads, opt, opt_cfg)
    return params, opt, {**metrics, **om}


def make_train_step(cfg, opt_cfg: OptConfig, device="cuda", *, mesh=None, rules=None):
    """``step(params, opt, batch) -> (params, opt, metrics)``: :func:`train_step`
    on ``device`` for any batch size and length; ``batch`` holds ``tokens``
    and ``labels`` (B, S) and, for the audio family, ``frames`` (B, Se,
    d_model).  ``params`` and ``opt`` are updated in place (the
    reference donates them).

    With ``mesh``: ``params`` and ``opt`` are DTensors
    (``step.distribute(params, opt)`` lays out full tensors), the batch is
    the global one (sharded here, or DTensors already), and the metrics
    come back as plain tensors."""
    require_ported(cfg)
    device = torch.device(device)
    if mesh is not None:
        rules = _rules_for(cfg, rules)
        _, bsh = batch_specs_like(cfg, mesh, rules)

        def sharded(params, opt, batch):
            batch = {k: shard(v, bsh[k]) for k, v in batch.items()}
            with use_mesh_rules(mesh, rules), implicit_replication():
                params, opt, metrics = train_step(params, opt, batch, cfg, opt_cfg)
            return params, opt, {k: full(v) for k, v in metrics.items()}

        def dist_state(params, opt=None):
            _, psh, _, osh = state_shardings(cfg, mesh, rules)
            params = distribute(params, psh)
            return params, (init_opt_state(params) if opt is None else distribute(opt, osh))

        sharded.distribute = dist_state
        return sharded

    def step(params, opt, batch):
        tokens = batch["tokens"]
        shape = (tokens.shape[0], tokens.shape[-1])                 # (B, S)
        _check("tokens", tokens, shape, device)
        _check("labels", batch["labels"], shape, device)
        if cfg.enc_dec:
            frames = batch["frames"]
            _check("frames", frames, (shape[0], *frames.shape[1:2], cfg.d_model), device)
        return train_step(params, opt, batch, cfg, opt_cfg)

    return step


# ---------------------------------------------------------------------------
# Serve steps
# ---------------------------------------------------------------------------

def make_decode_step(cfg, batch: int, max_len: int, device="cuda", *, mesh=None, rules=None):
    """``step(params, cache, token, pos) -> (logits (B, V) f32, cache)`` for
    ``batch`` sequences against a ``max_len``-slot cache (``step.init_cache
    (params)`` makes one); the cache is updated in place.

    With ``mesh``: DTensor params (``step.distribute(params)``) and cache
    (``step.init_cache``), global ``token`` and ``pos``; the logits come
    back as a DTensor laid out by ``("act_batch", "act_vocab")``."""
    require_ported(cfg)
    device = torch.device(device)
    if mesh is not None:
        rules = _rules_for(cfg, rules)
        vec = specs_to_shardings(("act_batch",), mesh, rules,
                                 torch.empty((batch,), device="meta"))   # batch 1 replicated

        @_span("step.decode")
        def sharded(params, cache, token, pos):
            token, pos = shard(token, vec), shard(pos, vec)
            with use_mesh_rules(mesh, rules), implicit_replication():
                return decode_step(params, cache, token, pos, cfg)

        def init(params):
            # K/V made as DTensors, the rest cut here
            with use_mesh_rules(mesh, rules), implicit_replication():
                cache = init_cache(params, cfg, batch, max_len)
            return distribute(cache, cache_shardings(cfg, mesh, batch, max_len, rules)[1])

        sharded.init_cache = init
        sharded.distribute = lambda params: distribute(
            params, state_shardings(cfg, mesh, rules, with_opt=False)[1])
        return sharded

    @_span("step.decode")
    def step(params, cache, token, pos):
        _check("token", token, (batch,), device)
        _check("pos", pos, (batch,), device)
        return decode_step(params, cache, token, pos, cfg)

    step.init_cache = lambda params: init_cache(params, cfg, batch, max_len)
    return step


def make_prefill_step(cfg, shape, device="cuda", *, mesh=None, rules=None):
    """``step(params, tokens) -> (last logits (B, V) f32, cache)`` for a
    ``ShapeConfig``'s (global_batch, seq_len) tokens.

    For the audio family, ``step(params, frames, enc_lens) -> cache``:
    frames (B, Se, M) and enc_lens (B,) int32; the encoder pass, its
    ``enc_norm``, then a cache of ``seq_len`` self-attention slots with the
    cross-attention K/V of the encoder's output.

    With ``mesh``: DTensor params (``step.distribute(params)``), the global
    tokens (or frames and enc_lens), sharded here as ``act_batch``."""
    require_ported(cfg)
    device = torch.device(device)
    B, S = shape.global_batch, shape.seq_len
    if cfg.enc_dec:
        @torch.no_grad()
        def encode(params, frames, enc_lens):
            pos = torch.arange(frames.shape[1], device=device)[None, :]
            enc_out = encdec.encoder_apply(params["enc_layers"], frames.to(pdtype(cfg)), cfg, pos)
            enc_out = rmsnorm(enc_out, params["enc_norm"], cfg.norm_eps)
            return encdec.init_encdec_cache(params, cfg, B, S, enc_out, enc_lens)

    if mesh is not None:
        rules = _rules_for(cfg, rules)
        tok = named_sharding(("act_batch", None), mesh, rules)

        if cfg.enc_dec:
            fr = named_sharding(("act_batch", None, None), mesh, rules)
            lens = specs_to_shardings(("act_batch",), mesh, rules,
                                      torch.empty((B,), device="meta"))

            @_span("step.prefill")
            def sharded(params, frames, enc_lens):
                with use_mesh_rules(mesh, rules), implicit_replication():
                    return encode(params, shard(frames, fr), shard(enc_lens, lens))
        else:
            @_span("step.prefill")
            def sharded(params, tokens):
                with use_mesh_rules(mesh, rules), implicit_replication():
                    return prefill(params, shard(tokens, tok), cfg, max_len=S)

        sharded.distribute = lambda params: distribute(
            params, state_shardings(cfg, mesh, rules, with_opt=False)[1])
        return sharded

    if cfg.enc_dec:
        @_span("step.prefill")
        def checked(params, frames, enc_lens):
            _check("frames", frames, (B, *frames.shape[1:2], cfg.d_model), device)
            _check("enc_lens", enc_lens, (B,), device)
            return encode(params, frames, enc_lens)

        return checked

    @_span("step.prefill")
    def step(params, tokens):
        _check("tokens", tokens, (B, S), device)
        return prefill(params, tokens, cfg, max_len=S)

    return step
