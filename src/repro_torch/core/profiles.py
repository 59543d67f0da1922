"""Job profiles — the TPU analogue of the paper's Nsight hardware counters.

A ``JobProfile`` stores per-slice-size roofline terms (compute/memory/
collective seconds per step), derived either from dry-run compiled artifacts
(``from_dryrun_record``) or analytically (``analytic_profile``).  From these
the paper's counter-derived features follow directly:

    Compute (SM) [%]  -> compute_pct  = compute term / step time
    Memory [%]        -> memory_pct   = memory term / step time
    Duration          -> steps x solo step time
    scalability       -> solo(1 unit) / solo(8 units) ratio

Classification (paper §V-A2, verbatim procedure):
    US if 1-unit-private run degrades < 10% vs the full 8-unit run;
    else CI if compute_pct / memory_pct > 0.80;
    else MI.
"""
from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field

from repro_torch.core.partition import CHIPS_PER_UNIT, N_UNITS, VALID_WIDTHS
from repro_torch.launch.roofline import HBM_BW, ICI_BW, PEAK_FLOPS, model_bytes_min, model_flops

# fixed per-step overhead (dispatch); plus per-collective ring latency that
# GROWS with slice width — small latency-bound jobs therefore run *better* on
# small slices, reproducing the paper's US (unscalable) class on TPU.
LAUNCH_LATENCY_S = 75e-6
HOP_LATENCY_S = 1.2e-6
COLL_BASE_LAT_S = 6e-6           # per sequential collective, fixed part
COLL_HOP_LAT_S = 1.0e-6          # per ring hop

FEATURES = (
    "compute_pct", "memory_pct", "coll_pct", "scalability",
    "log_duration", "log_flops", "serial_frac",
)


@dataclass
class JobProfile:
    name: str
    arch: str
    shape: str
    steps: int                                # job length in steps
    flops_total: float                        # per step, whole job
    bytes_total: float                        # per step, minimum HBM traffic
    coll_bytes_chip_pod: float                # per step per chip at full pod
    n_coll_step: int = 0                      # sequential collectives per step
    serial_s: float = 0.0                     # non-parallelizable per-step time
    meta: dict = field(default_factory=dict)

    # ---- per-slice roofline terms -----------------------------------------
    def terms(self, units: int, torus_factor: float | None = None) -> tuple[float, float, float]:
        chips = units * CHIPS_PER_UNIT
        tf = (1.0 if units == N_UNITS else 0.5) if torus_factor is None else torus_factor
        compute = self.flops_total / (chips * PEAK_FLOPS)
        memory = self.bytes_total / (chips * HBM_BW)
        # ring all-reduce payload per chip is ~size-independent of ring width;
        # add per-hop latency that grows with the ring (data axis rows).
        coll = self.coll_bytes_chip_pod / (ICI_BW * tf)
        return compute, memory, coll

    def fixed_latency(self, units: int) -> float:
        rows = units * 2                       # data-axis ring length in the slice
        return LAUNCH_LATENCY_S + HOP_LATENCY_S * (rows + 16)

    def coll_latency(self, units: int) -> float:
        """Latency of the per-step chain of sequential collectives (ring
        perimeter grows with slice width: wider slice = slower small-payload
        collectives)."""
        ring = 2 * units + 16                  # data-axis rows + model-axis ring
        return self.n_coll_step * (COLL_BASE_LAT_S + COLL_HOP_LAT_S * ring)

    def step_time(self, units: int, beta: float = 1.0, mem_factor: float = 1.0,
                  torus_factor: float | None = None, coll_bytes_factor: float = 1.0,
                  coll_lat_factor: float = 1.0) -> float:
        c, m, x = self.terms(units, torus_factor)
        x_tot = x * coll_bytes_factor + self.coll_latency(units) * coll_lat_factor
        return max(c / beta, m * mem_factor, x_tot) + self.fixed_latency(units) + self.serial_s

    # ---- paper counters ------------------------------------------------------
    def solo_step_time(self, units: int = N_UNITS) -> float:
        return self.step_time(units)

    def solo_time(self) -> float:
        return self.steps * self.solo_step_time()

    @property
    def compute_pct(self) -> float:
        c, _, _ = self.terms(N_UNITS)
        return c / self.solo_step_time()

    @property
    def memory_pct(self) -> float:
        _, m, _ = self.terms(N_UNITS)
        return m / self.solo_step_time()

    @property
    def coll_pct(self) -> float:
        _, _, x = self.terms(N_UNITS)
        return (x + self.coll_latency(N_UNITS)) / self.solo_step_time()

    @property
    def scalability(self) -> float:
        """step(1 unit) / step(8 units): 8 = perfect scaling, ~1 = unscalable."""
        return self.step_time(1) / self.step_time(N_UNITS)

    @property
    def serial_frac(self) -> float:
        return self.serial_s / self.solo_step_time()

    @property
    def requested_units(self) -> int:
        """Slice width the submission asks for (``meta["units"]``, default
        full pod).  This is the placement hint honored by the online
        dispatch layer — right-sized traces set it so unscalable jobs
        occupy only the slice they can actually use."""
        u = int(self.meta.get("units", N_UNITS))
        return u if u in VALID_WIDTHS else N_UNITS

    def right_size(self, tol: float = 1.25) -> int:
        """Narrowest slice width whose solo step time stays within ``tol``
        of the full-pod step time (MISO-style right-sizing).  US jobs
        right-size to 1 unit at any tolerance (they run *faster* on small
        slices — shorter collective rings), MI decode lands on 2-4 units at
        looser tolerances, scalable CI training stays full-pod."""
        full = self.step_time(N_UNITS)
        for u in (1, 2, 4):
            if self.step_time(u) <= tol * full:
                return u
        return N_UNITS

    @property
    def job_class(self) -> str:
        if self.step_time(1) / self.step_time(N_UNITS) < 1.1:
            return "US"
        if self.memory_pct > 0 and self.compute_pct / self.memory_pct > 0.80:
            return "CI"
        return "MI"

    def features(self, window_means: dict | None = None) -> list[float]:
        st = self.solo_step_time()
        vals = {
            "compute_pct": self.compute_pct,
            "memory_pct": self.memory_pct,
            "coll_pct": self.coll_pct,
            "scalability": self.scalability / N_UNITS,
            "log_duration": math.log10(max(self.solo_time(), 1e-9)) / 6.0,
            "log_flops": math.log10(max(self.flops_total, 1.0)) / 20.0,
            "serial_frac": self.serial_frac,
        }
        _ = st, window_means
        return [float(vals[k]) for k in FEATURES]


# ---------------------------------------------------------------------------
# Profile sources
# ---------------------------------------------------------------------------

def analytic_profile(cfg, shape, steps: int = 100, name: str | None = None) -> JobProfile:
    """Profile from the analytic cost model (no dry-run files needed)."""
    from repro_torch.launch.roofline import model_coll_bytes_chip

    flops = model_flops(cfg, shape)
    byts = model_bytes_min(cfg, shape)
    coll = model_coll_bytes_chip(cfg, shape)
    layers = max(1, cfg.n_layers + (cfg.n_enc_layers if cfg.enc_dec else 0))
    if shape.kind == "train":
        n_coll = 4 * layers + 8          # 2 fwd + 2 bwd TP ARs/layer + step-level
    else:
        n_coll = 2 * layers + 2
    serial = 0.0
    if cfg.family == "ssm" and shape.kind != "decode":
        # sLSTM sequential recurrence: per-token latency floor
        serial = shape.seq_len * (cfg.n_layers // 2) * 0.2e-6
    if shape.kind == "decode":
        # decode latency floor: one serial pass through the stack
        serial = cfg.n_layers * 2.0e-6
    return JobProfile(
        name=name or f"{cfg.name}:{shape.name}",
        arch=cfg.name, shape=shape.name, steps=steps,
        flops_total=flops, bytes_total=byts, coll_bytes_chip_pod=coll,
        n_coll_step=n_coll, serial_s=serial, meta={"source": "analytic"},
    )


def from_dryrun_record(rec: dict, cfg, shape, steps: int = 100) -> JobProfile:
    """Profile from a dry-run JSON record (compiled-artifact counters)."""
    chips = rec["chips"]
    prof = analytic_profile(cfg, shape, steps)
    prof.flops_total = rec["flops_per_chip"] * chips
    prof.bytes_total = rec["bytes_per_chip"] * chips
    prof.coll_bytes_chip_pod = rec["coll_bytes_weighted"]
    if rec.get("coll_count_unit"):
        prof.n_coll_step = int(rec["coll_count_unit"]) * int(rec.get("scan_units", 1))
    prof.meta = {"source": "dryrun", "mesh": rec["mesh"], "dominant": rec.get("dominant")}
    return prof


def load_dryrun_profiles(dryrun_dir: str, steps: int = 100) -> dict[str, JobProfile]:
    """All pod-mesh dry-run records -> profiles keyed by "arch:shape"."""
    from repro_torch.configs import get_config, get_shape

    out: dict[str, JobProfile] = {}
    if not os.path.isdir(dryrun_dir):
        return out
    for fn in sorted(os.listdir(dryrun_dir)):
        if not fn.endswith(".json"):
            continue
        with open(os.path.join(dryrun_dir, fn)) as f:
            rec = json.load(f)
        if not rec.get("ok") or rec.get("mesh") != "pod" or rec.get("rules") != "baseline":
            continue
        cfg = get_config(rec["arch"])
        shape = get_shape(rec["shape"])
        prof = from_dryrun_record(rec, cfg, shape, steps)
        out[f"{rec['arch']}:{rec['shape']}"] = prof
    return out


# ---------------------------------------------------------------------------
# ProfileRepository (paper §IV-B online protocol)
# ---------------------------------------------------------------------------

class ProfileRepository:
    """Keyed by job binary path+name (paper's matching function).

    Besides the lookup/insert protocol the online scheduler uses, the
    repository is the *training corpus* of the MISO-style periodic
    re-training loop (``repro.online.retrain``): ``jobs()`` snapshots the
    profiles collected so far so ``train_agent`` can refresh the agent
    against exactly the applications the cluster has actually seen.
    """

    def __init__(self):
        self._store: dict[str, JobProfile] = {}

    def key(self, binary_path: str) -> str:
        return binary_path

    def lookup(self, binary_path: str) -> JobProfile | None:
        return self._store.get(self.key(binary_path))

    def insert(self, binary_path: str, profile: JobProfile) -> None:
        self._store[self.key(binary_path)] = profile

    def jobs(self) -> list[JobProfile]:
        """Insertion-ordered snapshot of every profiled application."""
        return list(self._store.values())

    def class_counts(self) -> dict[str, int]:
        """CI/MI/US population of the repository (re-training gate input)."""
        out = {"CI": 0, "MI": 0, "US": 0}
        for p in self._store.values():
            out[p.job_class] += 1
        return out

    def __contains__(self, binary_path: str) -> bool:
        return self.key(binary_path) in self._store

    def __len__(self) -> int:
        return len(self._store)
