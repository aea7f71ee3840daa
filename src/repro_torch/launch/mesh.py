"""Meshes on ``torch.distributed.device_mesh`` (the port of
``repro.launch.mesh``).

Single pod: ``(data=16, model=16)`` — 256 ranks.
Multi-pod:  ``(pod=2, data=16, model=16)`` — 512 ranks; the ``pod`` axis
carries pure data parallelism, ``data`` carries ZeRO sharding, ``model``
carries TP/EP.

A mesh needs a process group of its size. A real run gets one from
``torchrun`` (NCCL); the dry run builds the production meshes in one process
over the fake backend (:func:`init_fake_world`), where every collective is a
no-op and no memory is allocated; a host run at world size 1 starts a
one-rank group on an in-memory store (:func:`make_host_mesh`).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def production_shape(multi_pod: bool) -> Tuple[Tuple[int, ...],
                                               Tuple[str, ...]]:
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def init_fake_world(world_size: int) -> None:
    """The single-process ``"fake"`` process group of ``world_size`` ranks
    that the dry run builds the production meshes on; a fake group of
    another size is replaced. The backend is registered by an internal
    module of PyTorch's test suite, imported here and nowhere else."""
    import torch.testing._internal.distributed.fake_pg as fake_pg

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()!r} process group is "
                               "running: the fake world needs a process of "
                               "its own")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=fake_pg.FakeStore(), rank=0,
                            world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """The production mesh over the running process group, which must have
    256 (single pod) or 512 (multi-pod) ranks."""
    shape, axes = production_shape(multi_pod)
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized() or dist.get_world_size() != n:
        have = dist.get_world_size() if dist.is_initialized() else None
        raise RuntimeError(f"the {'multi-pod' if multi_pod else 'single-pod'}"
                           f" mesh needs {n} ranks; the process group has "
                           f"{have}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(*, dp: int = 1, tp: int = 1,
                   device_type: str = "cuda") -> DeviceMesh:
    """A ``("data", "model")`` mesh for local runs. With no process group
    and dp * tp == 1 it starts a one-rank group on an in-memory store (NCCL
    on ``cuda``, gloo on ``cpu``); otherwise the running group must have dp
    * tp ranks."""
    if not dist.is_initialized() and dp * tp == 1:
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    return init_device_mesh(device_type, (dp, tp),
                            mesh_dim_names=("data", "model"))


def axis_sizes(mesh: DeviceMesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def dp_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    """The batch-sharding axes: ('pod','data') on multi-pod, ('data',) else."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def tp_size(mesh: DeviceMesh) -> int:
    return axis_sizes(mesh).get("model", 1)

