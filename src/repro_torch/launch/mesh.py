"""Meshes: the production pod and multi-pod meshes, test meshes and the
scheduler's slices, as ``torch.distributed`` ``DeviceMesh``es.

Port of ``repro/launch/mesh.py``.  Functions, not module constants, so that
importing this module touches no process group.  A mesh needs a world of
its size: under ``torchrun`` (or any initialised process group) the real
one, or :func:`fake_world`'s placeholder ranks, which stand in for the
reference's 512 placeholder host devices (``repro/launch/dryrun.py:1-2``):
every rank's shapes and collectives are traced, nothing is sent.
"""
from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _device_type(device_type: str | None) -> str:
    return device_type or ("cuda" if torch.cuda.is_available() else "cpu")


def make_production_mesh(*, multi_pod: bool = False, device_type: str | None = None) -> DeviceMesh:
    """16x16 = 256-chip pod; multi_pod stacks 2 pods on a leading "pod" axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(_device_type(device_type), shape, mesh_dim_names=axes)


def make_test_mesh(n_data: int = 2, n_model: int = 2, device_type: str | None = None) -> DeviceMesh:
    """A small ("data", "model") mesh over the first ``n_data * n_model`` ranks."""
    return DeviceMesh(_device_type(device_type),
                      torch.arange(n_data * n_model).reshape(n_data, n_model),
                      mesh_dim_names=("data", "model"))


def slice_mesh(mesh: DeviceMesh, lo_row: int, hi_row: int) -> DeviceMesh:
    """Rectangular sub-slice of a ("data","model") pod mesh along the data axis.

    This is the Level-1 *physical* partition: the sub-mesh owns its chips
    (compute + HBM) and intra-slice links exclusively; the perf model
    charges ``torus_factor = 1/2`` on the cut data axis.
    """
    ranks = mesh.mesh
    assert ranks.ndim == 2, "slice_mesh expects a single-pod (data, model) mesh"
    assert 0 <= lo_row < hi_row <= ranks.shape[0]
    return DeviceMesh(mesh.device_type, ranks[lo_row:hi_row, :], mesh_dim_names=("data", "model"))


def slice_meshes(mesh: DeviceMesh, widths: list[int]) -> list[DeviceMesh]:
    """Partition the pod's data axis into contiguous slices of ``widths`` rows."""
    assert sum(widths) <= mesh.mesh.shape[0]
    out, lo = [], 0
    for w in widths:
        out.append(slice_mesh(mesh, lo, lo + w))
        lo += w
    return out


@contextlib.contextmanager
def fake_world(n: int):
    """A process group of ``n`` placeholder ranks in this one process
    (rank 0), destroyed on exit.  Collectives on it move nothing, so a
    step run under it shows rank 0's local shapes, work and collectives;
    with ``FakeTensorMode`` nothing is allocated either.  Raises if a
    process group is already up."""
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already initialised")
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:   # a private module of torch's test suite
        raise RuntimeError(f"fake_world: torch {torch.__version__} has no fake process "
                           f"group ({e})") from e
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def launcher_mesh(n_data: int, n_model: int, device):
    """The ("data", "model") mesh of a launcher's ``--mesh-data`` x
    ``--mesh-model``.  Under ``torchrun`` (``WORLD_SIZE`` set) it joins that
    world (NCCL on the card, gloo on the CPU); otherwise it starts a world
    of one rank, so 1 x 1 runs on one device through the sharded path.  A
    mesh of another size than the world raises; a group it started is
    destroyed on exit."""
    device = torch.device(device)
    created = not dist.is_initialized()
    if created:
        backend = "nccl" if device.type == "cuda" else "gloo"
        if "WORLD_SIZE" in os.environ:
            if device.type == "cuda":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    try:
        world = dist.get_world_size()
        if n_data * n_model != world:
            raise ValueError(f"a {n_data} x {n_model} mesh needs a world of {n_data * n_model} "
                             f"ranks, and this one has {world} (run the launcher under "
                             f"torchrun --nproc-per-node {n_data * n_model})")
        yield make_test_mesh(n_data, n_model, device.type)
    finally:
        if created:
            dist.destroy_process_group()
