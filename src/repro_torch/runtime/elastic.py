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

The loop takes two kinds of mesh:

* a ``("data", "model")`` ``DeviceMesh`` of ranks, one process a device, as
  the reference's ``jax.sharding.Mesh`` of chips: the state is DTensors
  (``runtime/steps.py: make_train_step(..., mesh=mesh)`` lays it out), a
  checkpoint gathers every leaf to a full tensor (a collective of the mesh)
  and the mesh's first rank writes it, and a restore cuts each leaf to the
  template's layout.  A shrink builds the surviving rows' mesh on every rank
  of the world (``new_group`` is collective over it); the ranks left out
  return from :meth:`ElasticTrainer.run` at once.
* :class:`Mesh`, a grid of ``torch.device`` s with axis names and no
  sharding, as the reference's tests fake theirs by repeating their one CPU
  device (:func:`make_mesh` repeats one device).

The loop, the shrink and the restore are the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from repro_torch import checkpoint as ckpt_lib
from repro_torch.optim import tree_leaves, tree_map, tree_unflatten
from repro_torch.runtime.steps import full, local_shard


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


def surviving_mesh(mesh, failed_rows: list[int]):
    """Largest rectangular mesh from surviving data-axis rows.

    All surviving rows are kept (contiguity is not required: rows are
    re-indexed) up to a power-of-two row count, so power-of-two batch
    splits stay divisible: the rows ``keep[:n]``.  For a ``DeviceMesh``
    this is collective over the whole world: every rank calls it, those
    left out too (the new mesh's groups are made by ``new_group``)."""
    devices = mesh.mesh if isinstance(mesh, DeviceMesh) else np.asarray(mesh.devices)
    assert devices.ndim == 2
    keep = [r for r in range(devices.shape[0]) if r not in set(failed_rows)]
    if not keep:
        raise RuntimeError("all data rows failed")
    n = 1
    while n * 2 <= len(keep):
        n *= 2
    if isinstance(mesh, DeviceMesh):
        return DeviceMesh(mesh.device_type, devices[keep[:n]],
                          mesh_dim_names=mesh.mesh_dim_names)
    return Mesh(devices[keep[:n], :], mesh.axis_names)


def mesh_shape(mesh) -> tuple[int, ...]:
    """The mesh's shape, as the reference logs ``mesh.devices.shape``."""
    return tuple(mesh.mesh.shape) if isinstance(mesh, DeviceMesh) else np.asarray(
        mesh.devices).shape


def checkpoint_writer(mesh) -> int | None:
    """The rank that writes a ``DeviceMesh``'s checkpoints: its first
    (row 0's first rank, which is not rank 0 once row 0 has failed); None
    for a :class:`Mesh`, whose one process writes."""
    return int(mesh.mesh.flatten()[0]) if isinstance(mesh, DeviceMesh) else None


def _in_mesh(mesh) -> bool:
    return not isinstance(mesh, DeviceMesh) or mesh.get_coordinate() is not None


def _mesh_barrier(mesh: DeviceMesh) -> None:
    """Every rank of ``mesh`` has reached this point: a barrier over each
    mesh dim in turn (a rank passes the second only once every rank of its
    row passed the first, and so every rank of the mesh reached it)."""
    for name in mesh.mesh_dim_names:
        dist.barrier(group=mesh.get_group(name))


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
    makes fresh state on it; ``batch_fn(step, mesh)`` gives a step's global
    batch (a sharded step cuts each data row its slice).

    On a ``DeviceMesh`` every rank of the world runs the loop with the same
    arguments and failure events.  At a failure that drops its row a rank
    builds the new mesh with the others, then leaves: ``run`` returns
    ``(None, new_mesh)`` on it, and the survivors' state on theirs."""

    make_step: object
    init_state: object
    ckpt_dir: str
    ckpt_every: int = 10
    log: list = field(default_factory=list)

    def run(self, mesh, n_steps: int, batch_fn,
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
                if not _in_mesh(mesh):
                    return None, mesh
                step_fn = self.make_step(mesh)
                state = self.init_state(mesh)
                latest = ckpt_lib.latest_step(self.ckpt_dir)
                if latest is not None:
                    tree, _, step = ckpt_lib.restore(self.ckpt_dir, device="cpu")
                    state = self._load(state, tree, mesh)
                self.log.append(f"shrunk_to_{mesh_shape(mesh)}@{step}")
                continue
            batch = batch_fn(step, mesh)
            state = step_fn(state, batch)
            step += 1
            if step % self.ckpt_every == 0:
                self._commit(step, state, mesh)
                self.log.append(f"ckpt@{step}")
        return state, mesh

    def _commit(self, step: int, state, mesh) -> None:
        """Write ``state`` as the checkpoint of ``step``.  On a
        ``DeviceMesh`` every rank of it gathers the state, its first rank
        writes, and no rank goes on before the files are committed."""
        tree = self._dump(state)
        writer = checkpoint_writer(mesh)
        if writer is None or dist.get_rank() == writer:
            ckpt_lib.save(self.ckpt_dir, step, tree)
        if writer is not None:
            _mesh_barrier(mesh)

    # state <-> checkpoint tree
    @staticmethod
    def _dump(state):
        """The state as ``checkpoint.save`` writes it: every DTensor leaf
        gathered to a full CPU tensor (a collective every rank of its mesh
        joins), the other leaves as they are."""
        return tree_map(lambda t: full(t).detach().cpu() if isinstance(t, DTensor) else t,
                        state)

    @staticmethod
    def _load(state_template, tree, mesh):
        """``tree``'s leaves (full CPU tensors in the template's tree order,
        each of its saved dtype) on each template leaf's device, dtype and
        shape; a DTensor template leaf gets this rank's shard of its
        leaf, laid out as the template (no collective)."""
        if _paths(tree) != _paths(state_template):
            raise ValueError(f"checkpoint leaves {_paths(tree)} are not the state's "
                             f"{_paths(state_template)}")
        flat_t, flat_n = tree_leaves(state_template), tree_leaves(tree)
        out = [_place(n, t) if isinstance(t, DTensor)
               else n.to(device=t.device, dtype=t.dtype).reshape(t.shape)
               if isinstance(t, torch.Tensor) else n.numpy()
               for t, n in zip(flat_t, flat_n)]
        return tree_unflatten(state_template, out)


def _place(n: torch.Tensor, t: DTensor) -> DTensor:
    """This rank's shard of the full tensor ``n`` as a DTensor laid out as
    ``t`` (its mesh and placements), on ``t``'s device and dtype."""
    local = local_shard(n.to(t.dtype).reshape(t.shape), t.device_mesh, t.placements)
    return DTensor.from_local(local.to(t.to_local().device), t.device_mesh, t.placements,
                              run_check=False)


def _paths(tree: dict, prefix: str = "") -> list[str]:
    """The leaves' paths of a nested dict, in :func:`tree_leaves`' order."""
    return [p for k in sorted(tree)
            for p in (_paths(tree[k], f"{prefix}{k}|") if isinstance(tree[k], dict)
                      else [f"{prefix}{k}"])]
