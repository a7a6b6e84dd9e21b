"""Mesh builders over ``torch.distributed``.

Port of the JAX package's ``launch/mesh.py``.  All builders are functions
(not module-level constants), so importing this module starts no process
group and touches no device.

Under ``torchrun`` the process group comes from its environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``...), one rank a card.  Outside it,
:func:`init_process_group` starts a one-rank group over an in-process
``HashStore``, which needs no network.  NCCL on the card, gloo on the CPU.

:func:`fake_mesh` is the dry-run's: rank 0 of a group of any size over
torch's ``"fake"`` backend, whose collectives return at once without
moving a byte, so one process traces a 256- or 512-rank program with no
card and no network.  Unlike the reference's ``launch/mesh.py``, nothing
is set in the environment at import.
"""

from __future__ import annotations

import contextlib
import math
import os

import torch
import torch.distributed as dist

from repro_torch.kernels.ops import resolve_device


#: The production meshes' shapes and axis names, by the dry-run's mesh kind.
PRODUCTION = {"single": ((16, 16), ("data", "model")),
              "multi": ((2, 16, 16), ("pod", "data", "model"))}


def init_process_group(device=None) -> None:
    """Start the default process group if none is running: from
    ``torchrun``'s environment when it is set (each rank on card
    ``LOCAL_RANK``), else a one-rank group over a ``HashStore``.  NCCL for
    the card (``device=None`` or CUDA), gloo for the CPU."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


@contextlib.contextmanager
def process_group(device=None):
    """:func:`init_process_group` for the block; a group it started is
    destroyed at the end (one that was running is left alone)."""
    started = not dist.is_initialized()
    init_process_group(device)
    try:
        yield
    finally:
        if started:
            dist.destroy_process_group()


def _mesh(shape, axes, device=None):
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    init_process_group(dev)
    n = math.prod(shape)
    world = dist.get_world_size()
    if world < n:
        raise RuntimeError(
            f"mesh {tuple(shape)} needs {n} ranks, found {world}: start one "
            "rank a card with torchrun --nproc-per-node")
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16x16 = 256 ranks per pod; 2 pods = 512 ranks multi-pod."""
    return _mesh(*PRODUCTION["multi" if multi_pod else "single"], device)


def make_host_mesh(data: int = 1, model: int = 1, device=None):
    """A small ``("data", "model")`` mesh over the first ``data * model``
    ranks (tests, launchers).  ``device=None`` is the card; ``"cpu"``
    builds it over gloo."""
    return _mesh((data, model), ("data", "model"), device)



@contextlib.contextmanager
def fake_mesh(shape=(16, 16), axes=("data", "model")):
    """A ``DeviceMesh`` of ``shape`` over a fake process group, for the
    block: the default group starts with backend ``"fake"`` over a
    ``FakeStore``, this process its rank 0 of ``prod(shape)``, and is
    destroyed at the end.  Collectives on it return without moving data
    (their results are the inputs' shapes, uninitialised), so the mesh is
    for traces under a ``FakeTensorMode``.  Refuses to start while
    another default group is running: a process has one."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_mesh: a process group is already running; "
                           "destroy it first (a process has one default "
                           "group)")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield init_device_mesh("cuda", tuple(shape),
                               mesh_dim_names=tuple(axes))
    finally:
        dist.destroy_process_group()

