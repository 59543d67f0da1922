"""Cells of ``BENCHMARK.json`` cut to sizes a CPU test run can hold: the
configurations' widths and depths shrunk, the traffic's batches, lengths
and caches shrunk, everything else (the harness, the program's steps, the
reference, the limits) as it is."""
from __future__ import annotations

import contextlib
import copy

from portbench import harness

CONFIG_CUTS = {
    "seamless-m4t-large-v2": dict(n_layers=2, n_enc_layers=2, d_model=64, n_heads=4,
                                  n_kv_heads=4, d_head=16, d_ff=128, vocab_size=256, enc_len=24),
    "qwen2-moe-a2.7b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
                            d_ff=96, vocab_size=256,
                            moe={"n_routed": 6, "top_k": 2, "n_shared": 2, "d_expert": 48}),
}
# Wider cuts, for the control: its float8 error grows with width and depth,
# and at the smoke widths it stays under limits set at the cells' own size.
WIDER_CUTS = {
    "qwen2-moe-a2.7b": dict(n_layers=4, d_model=256, n_heads=4, n_kv_heads=4, d_head=64,
                            d_ff=128, vocab_size=2048,
                            moe={"n_routed": 8, "top_k": 2, "n_shared": 2, "d_expert": 128}),
}
TRAFFIC_CUTS = {
    "prefill": dict(batch=4, frames=24, slots=40, tokens=24, check_rows=2,
                    enc_lens=[24, 23, 7, 1]),
    "decode": dict(batch=4, slots=40, frames=24, starts=[37, 20, 5, 1], check_rows=2,
                   enc_lens=[24, 23, 7, 1]),
}


def spec(workload: str, dtype: str = "float32", wider: bool = False) -> dict:
    s = copy.deepcopy(harness.load_spec(workload))
    name = s["config"]["name"]
    cuts = dict(WIDER_CUTS[name] if wider else CONFIG_CUTS[name])
    if "moe" in cuts:                       # the widths cut, the routing settings kept
        cuts["moe"] = {**s["config"]["moe"], **cuts["moe"]}
    s["config"].update(cuts, dtype=dtype)
    for t in s["traffic"]["tenants"]:
        every_row = t.get("check_rows") == t["batch"]
        for k, v in TRAFFIC_CUTS[t["step"]].items():
            if k in t:
                t[k] = v
        if every_row:                       # a tenant checked whole stays whole
            t["check_rows"] = t["batch"]
    return s


def run(workload: str, seed: int = 7, dtype: str = "float32", wider: bool = False,
        **kw) -> dict:
    return harness.run(spec(workload, dtype, wider), seed, 0.05, False, "cpu",
                       log=lambda m: None, **kw)


FAULTS = ("prefill_repeats_first", "half_batch", "decode_half_batch", "decode_cache_unchanged",
          "token_altered")


@contextlib.contextmanager
def fault(name: str):
    """The timed path broken underneath the harness, in the program:

    - ``prefill_repeats_first``: the prefill step returns its first output
      again every time after (a step that returns its state unchanged);
    - ``half_batch``: the prefill step computes the first half of its batch
      and copies it into the second;
    - ``decode_half_batch``: the decode step computes the first half of its
      batch and copies its logits into the second, whose cache it never
      writes;
    - ``decode_cache_unchanged``: decode steps never write their K/V into
      the cache (a step that returns its state unchanged);
    - ``token_altered``: every row's best logit is moved to the next token,
      in decode and in a decoder-only prefill's last logits."""
    import torch

    import repro_torch.models.attention as attn
    import repro_torch.runtime.steps as steps

    saved = {(steps, "make_prefill_step"): steps.make_prefill_step,
             (steps, "decode_step"): steps.decode_step,
             (steps, "prefill"): steps.prefill, (attn, "_write_row"): attn._write_row}
    make = steps.make_prefill_step

    def alter(logits):
        best = logits.argmax(-1, keepdim=True)
        logits.scatter_(-1, (best + 1) % logits.shape[-1], logits.max(-1, keepdim=True).values + 1)
        return logits

    if name == "prefill_repeats_first":
        def make_prefill_step(*a, **k):
            step, first = make(*a, **k), []

            def again(*args):
                if not first:
                    first.append(step(*args))
                return first[0]
            return again
        steps.make_prefill_step = make_prefill_step
    elif name == "half_batch":
        def make_prefill_step(cfg, shape, *a, **k):
            half = type(shape)(shape.name, shape.seq_len, shape.global_batch // 2, shape.kind)
            step = make(cfg, half, *a, **k)

            def halved(params, x, *rest):
                n = x.shape[0] // 2
                out = step(params, x[:n], *(r[:n] for r in rest))
                if isinstance(out, tuple):        # (last logits, cache) of a decoder-only model
                    logits, cache = out
                    return (torch.cat([logits, logits]),
                            {k: torch.cat([v, v], 1) for k, v in cache.items()})
                return {g: {k: torch.cat([v, v], 1) for k, v in d.items()} for g, d in out.items()}
            return halved
        steps.make_prefill_step = make_prefill_step
    elif name == "decode_half_batch":
        dec = steps.decode_step

        def half(tree, n):
            return {k: half(v, n) if isinstance(v, dict) else v[:, :n] for k, v in tree.items()}

        def decode_step(params, cache, token, pos, cfg):
            n = token.shape[0] // 2
            logits, _ = dec(params, half(cache, n), token[:n], pos[:n], cfg)
            return torch.cat([logits, logits]), cache
        steps.decode_step = decode_step
    elif name == "decode_cache_unchanged":
        attn._write_row = lambda *a, **k: None
    elif name == "token_altered":
        dec, pre = steps.decode_step, steps.prefill

        def decode_step(*a, **k):
            logits, cache = dec(*a, **k)
            return alter(logits), cache

        def prefill(*a, **k):
            logits, cache = pre(*a, **k)
            return alter(logits), cache
        steps.decode_step, steps.prefill = decode_step, prefill
    else:
        raise ValueError(name)
    try:
        yield
    finally:
        for (mod, attr), v in saved.items():
            setattr(mod, attr, v)
