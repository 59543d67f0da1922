"""The port's profiler ranges, read back from an exported Chrome trace on
the CPU: ``executor.macro_step`` and ``executor.barrier`` in
``FusedCoRunner.run``, ``step.prefill`` and ``step.decode`` around the
serve steps, ``kv_cache.init`` in ``init_kv_cache`` and ``moe.host_sync``
around the MoE decode's read of its expert counts; and that the ranges
change no number the program computes."""
import contextlib
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.roofline import CostCounter
from repro_torch.models import model as tm
from repro_torch.optim import tree_leaves
from repro_torch.runtime.multitenant import FusedCoRunner, Tenant
from repro_torch.runtime.steps import make_decode_step, make_prefill_step

DECODE_STEPS = 3


def spans_of(fn, tmp_path):
    """``(fn()'s result, [(name, start, end)])`` of the ``user_annotation``
    ranges of ``fn`` run under the profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return out, sorted((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                       if e.get("cat") == "user_annotation")


def named(spans, name):
    return [s for s in spans if s[0] == name]


def within(spans, name, outer):
    return [s for s in named(spans, name) if outer[1] <= s[1] and s[2] <= outer[2]]


def test_executor_marks_each_macro_step_and_its_barrier(tmp_path):
    tenants = [Tenant("a", lambda s: s + 1, 0), Tenant("b", lambda s: s + 1, 0)]
    runner = FusedCoRunner(tenants, {"a": 4, "b": 2}, quanta_per_cycle=2)
    assert runner.quanta == [2, 2]
    _, spans = spans_of(runner.run, tmp_path)
    macro = named(spans, "executor.macro_step")
    assert len(macro) == 2                              # b done after one, a after two
    assert [len(within(spans, "executor.barrier", m)) for m in macro] == [1, 1]
    assert len(named(spans, "executor.barrier")) == 2
    assert [t.steps_done for t in tenants] == [4, 2] and [t.state for t in tenants] == [4, 2]


def _serve(cfg, params, tokens):
    B, S = tokens.shape
    shape = ShapeConfig("spans", S, B, "prefill")
    logits, _ = make_prefill_step(cfg, shape, device="cpu")(params, tokens)
    dec = make_decode_step(cfg, B, S + DECODE_STEPS, device="cpu")
    cache = dec.init_cache(params)
    tok, pos = logits.argmax(-1), torch.zeros(B, dtype=torch.int32)
    out = [logits]
    for _ in range(DECODE_STEPS):
        step_logits, cache = dec(params, cache, tok, pos)
        tok, pos = step_logits.argmax(-1), pos + 1
        out.append(step_logits)
    return out, cache


@pytest.fixture(scope="module")
def moe_model():
    cfg = get_smoke_config("qwen2-moe-a2.7b").replace(dtype="float32")
    params = tm.init_params(cfg, seed=3, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 8)))
    return cfg, params, tokens


def test_moe_serve_steps_mark_steps_caches_and_host_syncs(moe_model, tmp_path):
    cfg, params, tokens = moe_model
    _, spans = spans_of(lambda: _serve(cfg, params, tokens), tmp_path)
    prefill, decode = named(spans, "step.prefill"), named(spans, "step.decode")
    assert len(prefill) == 1 and len(decode) == DECODE_STEPS
    assert len(within(spans, "kv_cache.init", prefill[0])) == 1
    assert within(spans, "moe.host_sync", prefill[0]) == []
    n_moe = cfg.n_layers // cfg.moe.every
    assert [len(within(spans, "moe.host_sync", d)) for d in decode] == [n_moe] * DECODE_STEPS
    assert len(named(spans, "moe.host_sync")) == n_moe * DECODE_STEPS
    # the decode cache made outside the steps is a range of its own
    assert len(named(spans, "kv_cache.init")) == 2


def test_serve_steps_compute_the_same_with_the_profiler_on(moe_model, tmp_path):
    cfg, params, tokens = moe_model
    (on, cache_on), spans = spans_of(lambda: _serve(cfg, params, tokens), tmp_path)
    off, cache_off = _serve(cfg, params, tokens)
    assert spans and len(on) == len(off) == DECODE_STEPS + 1
    for a, b in zip(on, off):
        assert torch.equal(a, b)
    for n in ("k", "v"):
        assert torch.equal(cache_on[n], cache_off[n])


def test_cost_counter_counts_nothing_for_the_ranges(moe_model, monkeypatch):
    cfg, params, tokens = moe_model

    def counted():
        with CostCounter(existing=tree_leaves(params)) as cc:
            _serve(cfg, params, tokens)
        return cc.flops, cc.bytes, cc.bytes_raw, cc.peak

    on = counted()
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: contextlib.nullcontext())
    assert on == counted() and on[0] > 0


def test_encoder_step_marks_self_and_cross_cache_inits(tmp_path):
    cfg = get_smoke_config("seamless-m4t-large-v2").replace(dtype="float32")
    params = tm.init_params(cfg, seed=5, device="cpu")
    B, slots = 2, 24
    frames = torch.randn(B, cfg.enc_len, cfg.d_model, generator=torch.Generator().manual_seed(6))
    enc_lens = torch.tensor([cfg.enc_len, 5], dtype=torch.int32)
    step = make_prefill_step(cfg, ShapeConfig("spans", slots, B, "prefill"), device="cpu")
    cache, spans = spans_of(lambda: step(params, frames, enc_lens), tmp_path)
    (prefill,) = named(spans, "step.prefill")
    inits = within(spans, "kv_cache.init", prefill)
    assert len(inits) == 2 and named(spans, "moe.host_sync") == []
    assert cache["self"]["k"].shape[2] == slots and cache["cross"]["k"].shape[2] == cfg.enc_len
    assert torch.equal(cache["cross"]["k"], step(params, frames, enc_lens)["cross"]["k"])
