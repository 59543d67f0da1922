"""Hierarchical partition space for a TPU pod (paper Fig. 2 / Table VII analogue).

Level 1 (physical, ≈MIG GI): the 16x16 pod is cut along the data axis into
rectangular sub-mesh *slices* measured in units (1 unit = 2 rows = 32 chips,
8 units per pod — the analogue of the A100's 8 GPCs). Valid slice widths are
powers of two (XLA-friendly sub-meshes) — the TPU-native counterpart of MIG's
19-variant restriction. Cutting the torus breaks the wraparound link on the
cut axis (torus_factor 1/2 on data-axis collectives) — the TPU-native cost of
physical partitioning, standing in for MIG's lost GPC.

Level 2 (logical, ≈MPS): jobs co-resident on the same slice receive
fractional compute shares β (time-quantum multiplexing) while *sharing* the
slice's HBM bandwidth — flexible but interference-prone, exactly MPS's
semantics.

A ``Partition`` is an ordered list of slices with per-slot shares; jobs map
to slots in group-selection order (the agent learns the ordering, matching
the paper's C! assignment space).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass

N_UNITS = 8              # slice units per pod (1 unit = 32 chips on a 16x16 pod)
CHIPS_PER_UNIT = 32
POD_CHIPS = N_UNITS * CHIPS_PER_UNIT


@dataclass(frozen=True)
class Slice:
    units: int                       # width in units (1,2,4,8)
    shares: tuple[float, ...]        # Level-2 compute shares (sum <= 1)

    def __post_init__(self):
        assert self.units in (1, 2, 4, 8), self.units
        assert all(s > 0 for s in self.shares)
        assert sum(self.shares) <= 1.0 + 1e-9

    @property
    def chips(self) -> int:
        return self.units * CHIPS_PER_UNIT

    @property
    def shared_memory(self) -> bool:
        return len(self.shares) > 1

    @property
    def torus_factor(self) -> float:
        # full-pod slice keeps the data-axis wraparound ring; split slices don't
        return 1.0 if self.units == N_UNITS else 0.5


@dataclass(frozen=True)
class Partition:
    slices: tuple[Slice, ...]
    label: str

    @property
    def arity(self) -> int:
        return sum(len(s.shares) for s in self.slices)

    @property
    def slots(self) -> list[tuple[int, Slice, float]]:
        """Ordered (slice_idx, slice, share) job slots."""
        out = []
        for i, s in enumerate(self.slices):
            for beta in s.shares:
                out.append((i, s, beta))
        return out

    @property
    def total_units(self) -> int:
        return sum(s.units for s in self.slices)

    @property
    def style(self) -> str:
        """mps | mig | hier | solo — for baseline filtering (paper §V-A4)."""
        if self.arity == 1:
            return "solo"
        if len(self.slices) == 1 and self.slices[0].units == N_UNITS:
            return "mps"
        if all(len(s.shares) == 1 for s in self.slices):
            return "mig"
        return "hier"


VALID_WIDTHS = (1, 2, 4, 8)     # MIG-style power-of-two slice widths


def _width_label(units: int) -> str:
    """``1m`` / ``.5m`` / ``.25m`` / ``.125m`` — fraction-of-pod suffix."""
    return "1m" if units == N_UNITS else f"{units / N_UNITS:g}m".lstrip("0")


def slice_label(slices: tuple[Slice, ...]) -> str:
    """Regenerate a label in the table's grammar for derived partitions
    (width-fitted placements are not table entries, so they re-label)."""
    parts = []
    for s in slices:
        w = _width_label(s.units)
        if len(s.shares) == 1:
            parts.append(f"[{{{s.shares[0]:g}}},{w}]")
        else:
            parts.append("[" + "+".join(f"({b:g})" for b in s.shares) + f",{w}]")
    return "+".join(parts)


def _mps(label, *shares) -> Partition:
    return Partition((Slice(N_UNITS, tuple(shares)),), label)


def _p(label, *slices) -> Partition:
    return Partition(tuple(slices), label)


def enumerate_partitions(c_max: int = 4) -> list[Partition]:
    """The curated partition table (Table VII analogue). Stable order —
    the DQN's action indices point into this list."""
    table: list[Partition] = [
        _p("[{1.0},1m]", Slice(8, (1.0,))),                       # C=1 solo
    ]
    # --- C=2 ---------------------------------------------------------------
    table += [
        _mps(f"[({a:.1f})+({1-a:.1f}),1m]", a, round(1 - a, 2))
        for a in (0.1, 0.2, 0.3, 0.4, 0.5)
    ]
    table += [_p("[{.5},.5m]+[{.5},.5m]", Slice(4, (1.0,)), Slice(4, (1.0,)))]
    # --- C=3 ---------------------------------------------------------------
    table += [
        _mps("[(.1)+(.1)+(.8),1m]", 0.1, 0.1, 0.8),
        _mps("[(.2)+(.2)+(.6),1m]", 0.2, 0.2, 0.6),
        _mps("[(.2)+(.3)+(.5),1m]", 0.2, 0.3, 0.5),
        _mps("[(.33)+(.33)+(.34),1m]", 0.33, 0.33, 0.34),
        _p("[{.5},.5m]+[(.5)+(.5),{.5},.5m]", Slice(4, (1.0,)), Slice(4, (0.5, 0.5))),
        _p("[{.5},.5m]+[(.25)+(.75),{.5},.5m]", Slice(4, (1.0,)), Slice(4, (0.25, 0.75))),
        _p("[{.5},.5m]+[{.25},.25m]+[{.25},.25m]",
           Slice(4, (1.0,)), Slice(2, (1.0,)), Slice(2, (1.0,))),
    ]
    # --- C=4 ---------------------------------------------------------------
    table += [
        _mps("[(.1)+(.1)+(.1)+(.7),1m]", 0.1, 0.1, 0.1, 0.7),
        _mps("[(.25)x4,1m]", 0.25, 0.25, 0.25, 0.25),
        _mps("[(.1)+(.2)+(.3)+(.4),1m]", 0.1, 0.2, 0.3, 0.4),
        _p("[(.5)+(.5),{.5},.5m]x2",
           Slice(4, (0.5, 0.5)), Slice(4, (0.5, 0.5))),
        _p("[(.25)+(.75),{.5},.5m]x2",
           Slice(4, (0.25, 0.75)), Slice(4, (0.25, 0.75))),
        _p("[(.5)+(.5),{.5},.5m]+[{.25},.25m]x2",
           Slice(4, (0.5, 0.5)), Slice(2, (1.0,)), Slice(2, (1.0,))),
        _p("[{.25},.25m]x4",
           Slice(2, (1.0,)), Slice(2, (1.0,)), Slice(2, (1.0,)), Slice(2, (1.0,))),
    ]
    return [p for p in table if p.arity <= c_max]


def solo_partition(units: int = N_UNITS) -> Partition:
    """Single-slot partition on a ``units``-wide slice.

    The full-pod default is time sharing's unit and the slot unprofiled
    first-sight jobs run on in the online protocol; narrower widths are the
    placement layer's *right-sized* solo slices (a job whose trace carries a
    ``meta["units"]`` hint occupies only the slice it can actually use,
    leaving the rest of the pod for concurrent groups)."""
    if units == N_UNITS:
        return enumerate_partitions(1)[0]
    s = Slice(units, (1.0,))
    return Partition((s,), slice_label((s,)))


def aligned_offsets(width: int) -> tuple[int, ...]:
    """Valid start offsets for a ``width``-unit slice: buddy alignment (a
    power-of-two slice starts at a multiple of its width), the TPU-native
    counterpart of MIG's fixed GPC-slice anchor points."""
    assert width in VALID_WIDTHS, width
    return tuple(range(0, N_UNITS, width))


def find_offsets(partition: Partition, free) -> tuple[int, ...] | None:
    """First-fit-decreasing placement of ``partition``'s slices onto the
    ``free`` unit mask (length ``N_UNITS``, True = idle).

    Each slice claims a contiguous aligned range (:func:`aligned_offsets`);
    slices are placed widest-first so large slices are not blocked by the
    order smaller ones would claim gaps in.  Returns per-slice start offsets
    in *partition order*, or ``None`` when no first-fit placement exists —
    deterministic, so simulations replay bit-identically."""
    avail = list(free)
    assert len(avail) == N_UNITS, len(avail)
    order = sorted(range(len(partition.slices)),
                   key=lambda i: -partition.slices[i].units)
    starts: list[int | None] = [None] * len(partition.slices)
    for i in order:
        w = partition.slices[i].units
        for off in aligned_offsets(w):
            if all(avail[off:off + w]):
                starts[i] = off
                avail[off:off + w] = [False] * w
                break
        else:
            return None
    return tuple(starts)


def partitions_by_arity(c_max: int = 4) -> dict[int, list[Partition]]:
    out: dict[int, list[Partition]] = {}
    for p in enumerate_partitions(c_max):
        out.setdefault(p.arity, []).append(p)
    return out


def slot_assignments(group_size: int) -> list[tuple[int, ...]]:
    """All orderings of a group over a partition's slots (paper's C!)."""
    return list(itertools.permutations(range(group_size)))
