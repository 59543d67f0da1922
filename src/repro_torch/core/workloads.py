"""The benchmark-job zoo and queue construction (paper §V-A2 analogue).

Jobs are training/serving steps of the 10 assigned architectures at scaled
shape variants — the role Rodinia/CORAL play in the paper.  Profiles come
from dry-run artifacts when available (experiments/dryrun), else from the
analytic model.  Jobs are classified CI/MI/US with the paper's procedure and
queues are drawn per the paper's mix recipes (X-dominant = 50% X, rest
round-robin; Balanced = round-robin).
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs import SHAPES, get_config, scaled_shape
from repro_torch.core.profiles import JobProfile, analytic_profile, load_dryrun_profiles

# (arch, shape-id, batch_div, seq_div) — spans CI / MI / US behaviors.
# Job lengths (steps) are auto-balanced to a per-job target duration so that
# solo durations are comparable-but-varied (paper jobs run minutes each; the
# DurationRatio^2 reward presumes comparable scales).
_ZOO_SPEC: list[tuple[str, str, int, int]] = [
    # big dense training: compute-intensive (CI)
    ("qwen2.5-14b", "train_4k", 1, 1),
    ("llama3-8b", "train_4k", 1, 1),
    ("command-r-35b", "train_4k", 1, 1),
    ("mistral-nemo-12b", "train_4k", 1, 1),
    ("chameleon-34b", "train_4k", 1, 1),
    ("llama3-8b", "train_4k", 2, 1),
    ("jamba-v0.1-52b", "train_4k", 1, 1),
    # prefill: compute-bound inference (CI)
    ("llama3-8b", "prefill_32k", 1, 1),
    ("command-r-35b", "prefill_32k", 1, 1),
    ("mistral-nemo-12b", "prefill_32k", 1, 1),
    # MoE training / decode: bandwidth-leaning (MI)
    ("deepseek-moe-16b", "train_4k", 1, 1),
    ("qwen2-moe-a2.7b", "train_4k", 1, 1),
    ("llama3-8b", "decode_32k", 1, 1),
    ("qwen2.5-14b", "decode_32k", 1, 1),
    ("command-r-35b", "decode_32k", 1, 1),
    ("mistral-nemo-12b", "decode_32k", 1, 1),
    ("deepseek-moe-16b", "decode_32k", 1, 1),
    ("jamba-v0.1-52b", "decode_32k", 1, 1),
    ("chameleon-34b", "decode_32k", 1, 1),
    ("qwen2-moe-a2.7b", "decode_32k", 1, 1),
    # small / latency-bound: unscalable (US)
    ("xlstm-125m", "train_4k", 8, 4),
    ("xlstm-125m", "decode_32k", 1, 1),
    ("xlstm-125m", "long_500k", 1, 1),
    ("seamless-m4t-large-v2", "train_4k", 8, 8),
    ("seamless-m4t-large-v2", "decode_32k", 8, 4),
    ("jamba-v0.1-52b", "long_500k", 1, 1),
    ("llama3-8b", "decode_32k", 32, 8),
    ("qwen2-moe-a2.7b", "decode_32k", 16, 8),
    ("seamless-m4t-large-v2", "long_500k", 1, 32),
]

# deterministic varied target durations (seconds) — 3x spread like real queues
_TARGETS = (90.0, 150.0, 120.0, 60.0, 180.0, 75.0, 135.0)


def make_zoo(dryrun_dir: str | None = "experiments/dryrun") -> list[JobProfile]:
    """All zoo jobs with profiles; dry-run-backed where records exist."""
    dr = load_dryrun_profiles(dryrun_dir) if dryrun_dir else {}
    jobs: list[JobProfile] = []
    for i, (arch, shape_id, bd, sd) in enumerate(_ZOO_SPEC):
        cfg = get_config(arch)
        base = SHAPES[shape_id]
        if bd == 1 and sd == 1 and f"{arch}:{shape_id}" in dr:
            ref = dr[f"{arch}:{shape_id}"]
            prof = JobProfile(
                name=f"{arch}:{shape_id}#{i}", arch=arch, shape=shape_id,
                steps=1, flops_total=ref.flops_total, bytes_total=ref.bytes_total,
                coll_bytes_chip_pod=ref.coll_bytes_chip_pod, serial_s=ref.serial_s,
                meta=dict(ref.meta),
            )
        else:
            shape = scaled_shape(base, bd, sd)
            prof = analytic_profile(cfg, shape, 1, name=f"{arch}:{shape.name}#{i}")
        target = _TARGETS[i % len(_TARGETS)]
        prof.steps = max(1, int(round(target / prof.solo_step_time())))
        jobs.append(prof)
    return jobs


def zoo_by_class(jobs: list[JobProfile]) -> dict[str, list[JobProfile]]:
    out: dict[str, list[JobProfile]] = {"CI": [], "MI": [], "US": []}
    for j in jobs:
        out[j.job_class].append(j)
    return out


def make_queue(jobs: list[JobProfile], kind: str, window: int, rng: np.random.Generator,
               exclude: set[str] | None = None, strict: bool = True) -> list[JobProfile]:
    """Paper §V-A2 queue recipes: CI/MI/US-dominant or Balanced.

    ``strict=True`` (the default) demands every class be represented and
    raises otherwise — the historical contract for the curated zoo.  With
    ``strict=False`` missing classes are remapped round-robin onto the
    classes that *are* present, preserving the recipe's proportions as far
    as the pool allows; the online re-training loop needs this because the
    live :class:`~repro_torch.core.profiles.ProfileRepository` grows one observed
    application at a time and may not cover all three classes yet.
    """
    by_cls = zoo_by_class([j for j in jobs if not exclude or j.name not in exclude])
    classes = ["CI", "MI", "US"]
    missing = [c for c in classes if not by_cls[c]]
    if missing:
        if strict or len(missing) == len(classes):
            raise ValueError(f"zoo has no {missing[0]} jobs")
        avail = [c for c in classes if by_cls[c]]
        by_cls.update({m: by_cls[avail[i % len(avail)]]
                       for i, m in enumerate(missing)})
    picks: list[JobProfile] = []
    if kind == "balanced":
        seq = [classes[i % 3] for i in range(window)]
    else:
        dom = kind.upper()
        assert dom in classes, kind
        others = [c for c in classes if c != dom]
        seq = [dom] * (window // 2)
        seq += [others[i % 2] for i in range(window - len(seq))]
    for c in seq:
        pool = by_cls[c]
        picks.append(pool[int(rng.integers(0, len(pool)))])
    return picks


QUEUE_KINDS = ("ci", "mi", "us", "balanced")


def paper_queues(jobs: list[JobProfile], window: int = 12, seed: int = 0,
                 per_kind: int = 3) -> dict[str, list[JobProfile]]:
    """Q1..Q12 analogue: per_kind queues per category (paper Table V)."""
    rng = np.random.default_rng(seed)
    out: dict[str, list[JobProfile]] = {}
    qi = 1
    for kind in QUEUE_KINDS:
        for _ in range(per_kind):
            out[f"Q{qi}"] = make_queue(jobs, kind, window, rng)
            qi += 1
    return out
