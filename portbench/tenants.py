"""The general generator of a cell's work: one tenant of the Level-2
executor for each entry of a traffic file's ``tenants``, built on the
program's step factories (``repro_torch.runtime.steps``).

A tenant's ``step`` names the factory:

- ``prefill``: for the encoder-decoder, the encoder pass over ``batch`` x
  ``frames`` frame embeddings at ``enc_lens`` valid frames and the cross
  K/V of a session of ``slots`` self slots; for a decoder-only model, a
  causal prefill of ``batch`` x ``tokens`` prompt tokens.  ``input_sets``
  input batches are drawn from the seed and taken in turn.
- ``decode``: greedy decode steps of ``batch`` sequences against a cache
  of ``slots`` slots whose slots below ``starts`` are filled from the
  seed; each sequence's position wraps to its start after its last slot,
  so the cache keeps its size.  The encoder-decoder's cross K/V come from
  the prefill step on the first set of frames at ``enc_lens``.

Each tenant counts the positions it processed, the model operations its
shapes need (``flops.py``) and the attention kernels' launches with their
least times, and keeps what the correctness check compares: the last
prefill output's sampled rows, let go before the next output is made, and
of the step before it a fingerprint, layer 0's K and V at the sampled
rows' first ``FINGERPRINT`` positions, so that an output left over from
another input shows whichever input set the last step took; every served
token, and the sampled rows' logits of
the last ``KEPT_STEPS`` decode steps in a ring made at set-up.  So what
the check keeps on the card is the same in every macro-step and does not
grow with the steps a window holds.
"""
from __future__ import annotations

import torch

from portbench import flops, inputs

KEPT_STEPS = 16
FINGERPRINT = 64

def _region(name: str):
    return torch.profiler.record_function(f"portbench:{name}")


class PrefillTenant:
    def __init__(self, spec: dict, c: dict, cfg, weights: dict, seed: int, index: int, device,
                 rows: list[int]):
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.runtime.steps import make_prefill_step

        self.spec, self.c, self.name, self.rows = spec, c, spec["name"], rows
        self.kind = "prefill"
        B = spec["batch"]
        n_sets = spec.get("input_sets", 1)
        self.enc = bool(c.get("enc_dec"))
        if self.enc:
            self.length = spec["frames"]
            shape = ShapeConfig("portbench", spec["slots"], B, "prefill")
            self.inputs = [inputs.frames(seed, 10 * index + s, B, spec["frames"], c["d_model"],
                                         device) for s in range(n_sets)]
            self.enc_lens = torch.tensor(spec["enc_lens"], dtype=torch.int32, device=device)
            self.flops_step = flops.encoder_prefill_flops(c, B, spec["frames"])
            self.flash = [(B, spec["frames"], spec["frames"], c["n_heads"], c["n_kv_heads"],
                           c["d_head"], False)] * c["n_enc_layers"]
        else:
            self.length = spec["tokens"]
            shape = ShapeConfig("portbench", spec["tokens"], B, "prefill")
            self.inputs = [inputs.tokens(seed, 10 * index + s, (B, spec["tokens"]),
                                         c["vocab_size"], device) for s in range(n_sets)]
            self.flops_step = flops.lm_prefill_flops(c, B, spec["tokens"])
            self.flash = [(B, spec["tokens"], spec["tokens"], c["n_heads"], c["n_kv_heads"],
                           c["d_head"], True)] * c["n_layers"]
        self.positions_step = B * self.length
        self.step_fn_program = make_prefill_step(cfg, shape, device)
        self.weights = weights
        self.sample = None               # (input set, {what: tensor}) of the last step
        self.fingerprints: list = []     # (input set, (k, v)) of the last two steps
        self.steps = 0
        self.row_idx = torch.tensor(rows, device=device)

    def _sample(self, out) -> dict:
        all_rows = len(self.rows) == self.spec["batch"]

        def pick(t, dim):
            return t if all_rows else t.index_select(dim, self.row_idx)

        if self.enc:
            x = out["cross"]
            return {"k": pick(x["k"], 1), "v": pick(x["v"], 1)}
        logits, cache = out
        return {"logits": pick(logits, 0), "k": pick(cache["k"], 1), "v": pick(cache["v"], 1)}

    def _fingerprint(self, out) -> tuple:
        kv = out["cross"] if self.enc else out[1]
        return tuple(kv[n][0, :, :FINGERPRINT].index_select(0, self.row_idx) for n in ("k", "v"))

    def previous(self):
        """``(input set, (k, v))``: the fingerprint of the step before the
        last, or None."""
        return self.fingerprints[0] if len(self.fingerprints) == 2 else None

    def step(self, state):
        s = self.steps % len(self.inputs)
        self.sample = None              # the last output goes before the next is made
        with _region(self.name):
            if self.enc:
                out = self.step_fn_program(self.weights, self.inputs[s], self.enc_lens)
            else:
                out = self.step_fn_program(self.weights, self.inputs[s])
            self.sample = (s, self._sample(out))
            self.fingerprints = (self.fingerprints + [(s, self._fingerprint(out))])[-2:]
        self.steps += 1
        return state

    def flops_at(self, step: int) -> float:
        return self.flops_step

    def decode_bounds_at(self, step: int) -> list:
        return []

    def release(self):
        self.step_fn_program = None


class DecodeTenant:
    def __init__(self, spec: dict, c: dict, cfg, weights: dict, seed: int, index: int, device,
                 rows: list[int]):
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.runtime.steps import make_decode_step, make_prefill_step

        self.spec, self.c, self.name, self.rows = spec, c, spec["name"], rows
        self.kind = "decode"
        self.seed, self.index = seed, index
        B, slots = spec["batch"], spec["slots"]
        self.starts = list(spec["starts"])
        if len(self.starts) != B or max(self.starts) >= slots or min(self.starts) < 1:
            raise ValueError(f"{self.name}: starts must be {B} positions in [1, {slots})")
        self.enc = bool(c.get("enc_dec"))
        self.weights = weights
        prog = make_decode_step(cfg, B, slots, device)
        with torch.no_grad():
            if self.enc:
                self.frames = inputs.frames(seed, 10 * index, B, spec["frames"], c["d_model"],
                                            device)
                self.enc_lens = torch.tensor(spec["enc_lens"], dtype=torch.int32, device=device)
                pre = make_prefill_step(cfg, ShapeConfig("portbench", slots, B, "prefill"), device)
                self.cache = pre(weights, self.frames, self.enc_lens)
                kv = self.cache["self"]
            else:
                self.cache = prog.init_cache(weights)
                kv = self.cache
            for i, k, v in self.first_slabs(device):
                kv["k"][i].copy_(k)
                kv["v"][i].copy_(v)
        self.prog = prog
        self.tok0 = inputs.tokens(seed, 10 * index + 9, (B,), c["vocab_size"], device)
        self.start_dev = torch.tensor(self.starts, dtype=torch.int32, device=device)
        self.state0 = (self.tok0, self.start_dev.clone())
        self.served: list = []          # the token each step served, (B,) each
        # the sampled rows' logits of the last KEPT_STEPS steps, step s at s % KEPT_STEPS
        self.ring = torch.empty((KEPT_STEPS, len(rows), c["vocab_size"]), dtype=torch.float32,
                                device=device)
        self.row_idx = torch.tensor(rows, device=device)
        self.steps = 0
        self.positions_step = B
        self.flash = []

    def first_slabs(self, device):
        """The cache's first contents, layer by layer (``inputs.cache_slabs``)."""
        shape = (self.spec["batch"], self.spec["slots"], self.c["n_kv_heads"], self.c["d_head"])
        return inputs.cache_slabs(self.seed, self.index, self.c["n_layers"], shape,
                                  torch.bfloat16, device)

    def pos_at(self, step: int) -> list[int]:
        """Each row's position at decode step ``step`` (from 0)."""
        slots = self.spec["slots"]
        return [s + step % (slots - s) for s in self.starts]

    def step(self, state):
        tok, pos = state
        with _region(self.name):
            logits, _ = self.prog(self.weights, self.cache, tok, pos)
            nxt = logits.argmax(dim=-1)
            torch.index_select(logits, 0, self.row_idx, out=self.ring[self.steps % KEPT_STEPS])
            pos = torch.where(pos + 1 >= self.spec["slots"], self.start_dev, pos + 1)
        self.served.append(nxt)
        self.steps += 1
        return nxt, pos

    def logits_at(self, step: int):
        """The sampled rows' logits of decode step ``step``, if still kept."""
        if step < self.steps - KEPT_STEPS:
            return None
        return self.ring[step % KEPT_STEPS]

    def flops_at(self, step: int) -> float:
        lengths = [p + 1 for p in self.pos_at(step)]
        return flops.decode_flops(self.c, lengths, self.spec.get("enc_lens"))

    def decode_bounds_at(self, step: int) -> list:
        """The least time of each decode attention launch of step ``step``."""
        c = self.c
        args = (c["n_heads"], c["n_kv_heads"], c["d_head"], c["dtype"])
        own = flops.decode_bound_s([p + 1 for p in self.pos_at(step)], *args)
        out = [own] * c["n_layers"]
        if self.enc:
            out += [flops.decode_bound_s(self.spec["enc_lens"], *args)] * c["n_layers"]
        return out

    def release(self):
        self.prog = self.cache = None


KINDS = {"prefill": PrefillTenant, "decode": DecodeTenant}
