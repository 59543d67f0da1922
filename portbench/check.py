"""Whether what the timed path produced is correct: the program's outputs
against the plain reference of ``portbench/reference``, run once the
window has closed and the program's state is freed.

Numbers compared (each has a limit in ``portbench/limits/<cell>.json``),
every answer read for one sampled row:

- ``<tenant>.kv_rel_err``: of the window's last prefill step, each
  layer's K and V (the encoder-decoder's cross K/V, a decoder-only
  prefill's cache) of a row, ``||program - ref|| / ||ref||``.
- ``<tenant>.kv_pos_median_err``: the same K and V of a row, the median
  over its positions of each position's relative error (over its heads).
  Both numbers also read the step before the last by its fingerprint
  (layer 0's K and V at its first positions), as rows of their own.
  A MoE's K/V hold a few positions whose top-k turns on the last bit of a
  router logit: they set the norm of the difference, and this number sets
  them aside.
- ``<tenant>.token_gap``: the gap by which a served token's logit lies
  below the reference's best, at every decode step of a row (the
  reference decodes the program's served tokens); for a decoder-only
  prefill, of the token its last logits put first.
- ``<tenant>.logits_rel_err``: the same logits' ``||program - ref|| /
  ||ref||``, a row and a step (decode: the steps the tenant kept, its
  last ones; a decoder-only prefill: its last logits).

A limits file names the numbers a cell compares, each with its limit and
the statistic over its answers that is held to it: ``max``, the worst
answer, or ``row_median_max``, each row's median over its answers and the
worst of those over the rows, which lets a row's odd step pass and no
row that is wrong at most of its steps.  The other readings are printed
and not compared.

The control (``control=True``) stands the reference computed in float8
(``Precision("fp8")``) in the program's place and reads the same numbers
against the f32 reference: its K/V and logits errors, and at each
position of the same tokens the gap of the token it puts first.
"""
from __future__ import annotations

import statistics

import torch

from portbench.reference import encdec as ref_encdec
from portbench.reference import moe_lm as ref_lm
from portbench.reference.common import Precision, strict_f32

F32, FP8 = Precision("f32"), Precision("fp8")


def _gap(ref_logits: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """(B,) the reference's best logit minus its logit of ``chosen``."""
    return ref_logits.max(-1).values - ref_logits.gather(-1, chosen.long()[:, None])[:, 0]


class Readings:
    """Each compared number's readings: the program's (or the control's)
    value per answer, and the row each answer is of."""

    def __init__(self):
        self.values: dict[str, list[float]] = {}
        self.rows: dict[str, list[int]] = {}

    def add(self, name: str, vals, rows) -> None:
        vals, rows = [float(v) for v in vals], [int(r) for r in rows]
        assert len(vals) == len(rows), (name, len(vals), len(rows))
        self.values.setdefault(name, []).extend(vals)
        self.rows.setdefault(name, []).extend(rows)

    def summary(self) -> dict[str, str]:
        """Each number's answers: count, quartiles, 90th and 99th
        percentile, max, and the worst row's median."""
        out = {}
        for k, v in self.values.items():
            q = torch.tensor(v, dtype=torch.float64).quantile(
                torch.tensor([0.25, 0.5, 0.75, 0.9, 0.99], dtype=torch.float64)).tolist()
            worst = max(statistics.median(a) for a in _by_row(v, self.rows[k]).values())
            out[k] = (f"n={len(v)} q25={q[0]:.4g} median={q[1]:.4g} q75={q[2]:.4g} "
                      f"p90={q[3]:.4g} p99={q[4]:.4g} max={max(v):.4g} "
                      f"worst_row_median={worst:.4g}")
        return out


def _row_rel(a: torch.Tensor, b: torch.Tensor) -> list[float]:
    return ((a.float() - b).norm(dim=-1) / b.norm(dim=-1).clamp_min(1e-30)).tolist()


def _logits(name: str, ref: torch.Tensor, got: torch.Tensor, rows, r: "Readings",
            rel: bool = True) -> None:
    """Readings of logits ``got`` (B, V) of ``rows`` against the
    reference's: the gap of the token ``got`` puts first and, with ``rel``,
    the rows' relative error."""
    r.add(f"{name}.token_gap", _gap(ref, got.argmax(-1)).tolist(), rows)
    if rel:
        r.add(f"{name}.logits_rel_err", _row_rel(got, ref), rows)


def _kv(name: str, kr, vr, k, v, rows, r: "Readings") -> None:
    """Readings of one layer's K and V (B, S, H, D) of ``rows`` against the
    reference's: each row's relative error, and its median over positions."""
    for got, ref in ((k, kr), (v, vr)):
        diff = got.float() - ref
        whole = diff.flatten(1).norm(dim=-1) / ref.flatten(1).norm(dim=-1).clamp_min(1e-30)
        r.add(f"{name}.kv_rel_err", whole.tolist(), rows)
        pos = diff.norm(dim=(-2, -1)) / ref.norm(dim=(-2, -1)).clamp_min(1e-30)
        r.add(f"{name}.kv_pos_median_err", pos.median(dim=1).values.tolist(), rows)


def _encoder_rows(w, c, frames, rows, pr):
    return ref_encdec.encoder(w, frames.index_select(0, rows), c, pr)


def _rows(gen, rows):
    """A prefill reference's items cut to the sampled ``rows``."""
    for i, k, v in gen:
        yield i, k.index_select(0, rows), (None if v is None else v.index_select(0, rows))


def check_prefill(t, w, c, prog: Readings, ctrl: Readings | None) -> None:
    rows = torch.tensor(t.rows, device=t.row_idx.device)
    s, sample = t.sample
    if t.enc:
        gens = [ref_encdec.cross_kv(w, _encoder_rows(w, c, t.inputs[s], rows, pr), c, pr)
                for pr in ((F32, FP8) if ctrl else (F32,))]
    else:
        # the whole batch: an expert's capacity counts every row's tokens
        gens = [_rows(ref_lm.prefill(w, t.inputs[s], c, pr), rows)
                for pr in ((F32, FP8) if ctrl else (F32,))]
    for items in zip(*gens):
        i, kr, vr = items[0]
        if i == "logits":
            _logits(t.name, kr, sample["logits"], t.rows, prog)
            if ctrl:
                _logits(t.name, kr, items[1][1], t.rows, ctrl)
            continue
        _kv(t.name, kr, vr, sample["k"][i], sample["v"][i], t.rows, prog)
        if ctrl:
            _kv(t.name, kr, vr, items[1][1], items[1][2], t.rows, ctrl)


PREVIOUS = 10 ** 6          # the rows of the step before the last are read as rows of their own


def _layer0(t, w, c, s: int, rows, pr):
    """The reference's layer-0 K and V of input set ``s`` at ``rows``."""
    if t.enc:
        gen = ref_encdec.cross_kv(w, _encoder_rows(w, c, t.inputs[s], rows, pr), c, pr)
    else:
        gen = _rows(ref_lm.prefill(w, t.inputs[s], c, pr), rows)
    _, k, v = next(gen)
    return k, v


def check_previous(t, w, c, prog: Readings, ctrl: Readings | None) -> None:
    """The fingerprint of the step before the last against the
    reference's layer 0 on that step's input set."""
    prev = t.previous()
    if prev is None:
        return
    s, (k, v) = prev
    rows = torch.tensor(t.rows, device=t.row_idx.device)
    n, keys = k.shape[1], [PREVIOUS + r for r in t.rows]
    kr, vr = (x[:, :n] for x in _layer0(t, w, c, s, rows, F32))
    _kv(t.name, kr, vr, k, v, keys, prog)
    if ctrl is not None:
        kl, vl = (x[:, :n] for x in _layer0(t, w, c, s, rows, FP8))
        _kv(t.name, kr, vr, kl, vl, keys, ctrl)


def _decoders(t, w, c, rows, pr):
    first = ((i, k.index_select(0, rows), v.index_select(0, rows))
             for i, k, v in t.first_slabs(rows.device))
    if t.enc:
        enc = _encoder_rows(w, c, t.frames, rows, pr)
        return ref_encdec.Decoder(w, c, pr, first, ref_encdec.cross_kv(w, enc, c, pr),
                                  t.enc_lens.index_select(0, rows), t.spec["slots"])
    return ref_lm.Decoder(w, c, pr, first, t.spec["slots"])


def check_decode(t, w, c, prog: Readings, ctrl: Readings | None) -> None:
    """Every step the tenant served, from its first: the served tokens'
    gaps at each, the logits' error at the steps whose logits it kept."""
    rows = torch.tensor(t.rows, device=t.tok0.device)
    ref = _decoders(t, w, c, rows, F32)
    low = _decoders(t, w, c, rows, FP8) if ctrl else None
    tok = t.tok0.index_select(0, rows)
    for step, served in enumerate(t.served):
        pos = torch.tensor([t.pos_at(step)[r] for r in t.rows], dtype=torch.int32,
                           device=rows.device)
        lr = ref.step(tok, pos)
        served = served.index_select(0, rows)
        kept = t.logits_at(step)
        prog.add(f"{t.name}.token_gap", _gap(lr, served).tolist(), t.rows)
        if kept is not None:
            prog.add(f"{t.name}.logits_rel_err", _row_rel(kept, lr), t.rows)
        if low is not None:
            _logits(t.name, lr, low.step(tok, pos), t.rows, ctrl, rel=kept is not None)
        tok = served


def check(tenants, weights, c: dict, control: bool = False):
    """``(program readings, control readings or None)``."""
    strict_f32()
    prog, ctrl = Readings(), (Readings() if control else None)
    with torch.no_grad():
        for t in tenants:
            if t.kind == "prefill":
                check_prefill(t, weights, c, prog, ctrl)
                check_previous(t, weights, c, prog, ctrl)
            else:
                check_decode(t, weights, c, prog, ctrl)
    return prog, ctrl


def _by_row(vals: list[float], rows: list[int]) -> dict[int, list[float]]:
    out: dict[int, list[float]] = {}
    for v, r in zip(vals, rows):
        out.setdefault(r, []).append(v)
    return out


def _answers(stat: str, vals: list[float], rows: list[int]) -> list[list[float]]:
    """The answers a statistic judges one by one: each value for ``max``,
    each row's values for ``row_median_max``."""
    if stat == "max":
        return [[v] for v in vals]
    if stat == "row_median_max":
        return list(_by_row(vals, rows).values())
    raise ValueError(stat)


def verdict(readings: Readings, limits: dict) -> tuple[dict, int, int]:
    """``({name: {"value", "limit", "stat"}}, answers compared, answers
    failed)`` over the numbers ``limits`` names (``{name: {"stat",
    "limit"}}``).  An answer is a value (``max``) or a row's values, read
    as their median (``row_median_max``); it fails over its limit, and the
    number's value is the worst answer.  A number named there without
    readings fails."""
    out, attempted, failed = {}, 0, 0
    for name, lim in limits.items():
        answers = [statistics.median(a) for a in
                   _answers(lim["stat"], readings.values.get(name, []),
                            readings.rows.get(name, []))]
        attempted += len(answers)
        failed += sum(not a <= lim["limit"] for a in answers) if answers else 1
        out[name] = {"value": max(answers) if answers else float("nan"),
                     "limit": lim["limit"], "stat": lim["stat"]}
    return out, attempted, failed
