"""Elastic scaling + failure recovery for the training runtime.

Port of ``repro/runtime/elastic.py``: checkpoint-based recovery.

  * Failures are detected per data-axis *row* of the device mesh (a host
    owns whole rows; losing a host removes its rows).
  * Recovery = rebuild a rectangular mesh from the surviving rows, restore
    the last committed checkpoint onto it, and re-partition the global
    batch over the shrunken data axis (:func:`rebalance_bounds`).
  * The data pipeline is counter-based (``repro_torch.data``), so batch
    re-partitioning is a pure function of (step, new row range): there is
    no iterator state to migrate.

The reference's mesh is a ``jax.sharding.Mesh``; here :class:`Mesh` is the
same thing without sharding: a 2-D array of ``torch.device`` s with axis
names.  Multi-GPU is out of scope, so on the card every row is the one
card (:func:`make_mesh` repeats it), as the reference's tests repeat their
one CPU device; the loop, the shrink and the restore are the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import checkpoint as ckpt_lib
from repro_torch.optim import tree_leaves, tree_unflatten


@dataclass(frozen=True, eq=False)
class Mesh:
    """A grid of devices: ``devices`` a 2-D object array of ``torch.device``
    (rows on the data axis), ``axis_names`` one name an axis."""

    devices: np.ndarray
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def make_mesh(shape: tuple[int, int], axis_names=("data", "model"), device="cuda") -> Mesh:
    """A ``shape`` grid whose every entry is ``device``."""
    devices = np.empty(shape, dtype=object)
    devices.fill(torch.device(device))
    return Mesh(devices, tuple(axis_names))


@dataclass
class FailureEvent:
    step: int
    failed_rows: list[int]            # data-axis rows lost at this step


def surviving_mesh(mesh: Mesh, failed_rows: list[int]) -> Mesh:
    """Largest rectangular mesh from surviving data-axis rows.

    All surviving rows are kept (contiguity is not required: rows are
    re-indexed) up to a power-of-two row count, so power-of-two batch
    splits stay divisible."""
    devices = np.asarray(mesh.devices)
    assert devices.ndim == 2
    keep = [r for r in range(devices.shape[0]) if r not in set(failed_rows)]
    if not keep:
        raise RuntimeError("all data rows failed")
    n = 1
    while n * 2 <= len(keep):
        n *= 2
    return Mesh(devices[keep[:n], :], mesh.axis_names)


def rebalance_bounds(global_batch: int, n_rows: int, row: int) -> tuple[int, int]:
    """Row's [lo, hi) slice of the global batch after elastic resize."""
    per = global_batch // n_rows
    rem = global_batch % n_rows
    lo = row * per + min(row, rem)
    return lo, lo + per + (1 if row < rem else 0)


@dataclass
class ElasticTrainer:
    """Checkpoint-restart elastic loop.  ``make_step(mesh)`` builds the
    step ``(state, batch) -> state`` for a mesh; ``init_state(mesh)``
    makes fresh state on it; ``batch_fn(step, mesh)`` gives a step's batch."""

    make_step: object
    init_state: object
    ckpt_dir: str
    ckpt_every: int = 10
    log: list = field(default_factory=list)

    def run(self, mesh: Mesh, n_steps: int, batch_fn,
            failures: list[FailureEvent] | None = None):
        failures = list(failures or [])
        step_fn = self.make_step(mesh)
        state = self.init_state(mesh)
        step = 0
        # resume if a committed checkpoint exists (restart-after-crash path)
        latest = ckpt_lib.latest_step(self.ckpt_dir)
        if latest is not None:
            tree, _, step = ckpt_lib.restore(self.ckpt_dir, device="cpu")
            state = self._load(state, tree, mesh)
            self.log.append(f"resumed@{step}")

        while step < n_steps:
            pending = [f for f in failures if f.step == step]
            if pending:
                # failure: shrink the mesh, restore the last commit, rebalance.
                # The handled events are removed BY IDENTITY before the restore
                # rewinds `step`: filtering by step after the rewind would
                # leave an event armed and fire it again forever.
                failures = [f for f in failures if not any(f is p for p in pending)]
                mesh = surviving_mesh(mesh, [r for f in pending for r in f.failed_rows])
                step_fn = self.make_step(mesh)
                state = self.init_state(mesh)
                latest = ckpt_lib.latest_step(self.ckpt_dir)
                if latest is not None:
                    tree, _, step = ckpt_lib.restore(self.ckpt_dir, device="cpu")
                    state = self._load(state, tree, mesh)
                self.log.append(f"shrunk_to_{np.asarray(mesh.devices).shape}@{step}")
                continue
            batch = batch_fn(step, mesh)
            state = step_fn(state, batch)
            step += 1
            if step % self.ckpt_every == 0:
                ckpt_lib.save(self.ckpt_dir, step, self._dump(state))
                self.log.append(f"ckpt@{step}")
        return state, mesh

    # state <-> checkpoint tree (override for sharded state)
    @staticmethod
    def _dump(state):
        """The state as ``checkpoint.save`` writes it (numpy leaves, bf16 as
        the reference writes it)."""
        return state

    @staticmethod
    def _load(state_template, tree, mesh):
        """``tree``'s leaves (CPU tensors in the template's tree order) on
        each template leaf's device, dtype and shape."""
        if _paths(tree) != _paths(state_template):
            raise ValueError(f"checkpoint leaves {_paths(tree)} are not the state's "
                             f"{_paths(state_template)}")
        flat_t, flat_n = tree_leaves(state_template), tree_leaves(tree)
        out = [n.to(device=t.device, dtype=t.dtype).reshape(t.shape)
               if isinstance(t, torch.Tensor) else n.numpy()
               for t, n in zip(flat_t, flat_n)]
        return tree_unflatten(state_template, out)


def _paths(tree: dict, prefix: str = "") -> list[str]:
    """The leaves' paths of a nested dict, in :func:`tree_leaves`' order."""
    return [p for k in sorted(tree)
            for p in (_paths(tree[k], f"{prefix}{k}|") if isinstance(tree[k], dict)
                      else [f"{prefix}{k}"])]
