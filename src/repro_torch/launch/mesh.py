"""Device meshes over the process group (the JAX package's
``launch/mesh.py``).

Single pod:  (16, 16)   axes ("data", "model")   = 256 ranks
Multi-pod:   (2, 16, 16) axes ("pod", "data", "model") = 512 ranks.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` built with
``init_device_mesh`` over the process group that exists, so
``init_distributed`` (or ``torchrun``'s environment and
``init_process_group``) comes first, or ``init_fake`` for a dry run of
the production meshes in one process.  Meshes are ``"cuda"`` by default;
the CPU is used only when the caller asks for it (``device="cpu"``).
Defined as functions, never module-level constants, so importing this
module touches no process group.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device


def init_distributed(device: DeviceLike = None,
                     init_file: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> None:
    """Start the default process group, unless one exists.

    The backend follows from the device: NCCL for CUDA (the default),
    gloo for ``device="cpu"``.  The rendezvous is ``file://init_file``
    when given (with ``rank`` and ``world_size``), else the ``env://``
    of ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``
    that ``torchrun`` sets.  On CUDA each rank takes card ``LOCAL_RANK``
    modulo the cards there are."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank or 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    if init_file is not None:
        dist.init_process_group(backend, init_method=f"file://{init_file}",
                                rank=rank, world_size=world_size)
    else:
        dist.init_process_group(backend, init_method="env://")


def init_fake(world: int) -> None:
    """Start torch's fake process group of ``world`` ranks in this one
    process, as rank 0 (``launch.dryrun``'s meshes: a (16, 16) or (2, 16,
    16) mesh on ``meta`` tensors, no card and no other process).  Its
    collectives move nothing; the tensors they would fill are shapes.
    A fake group of another size is replaced; a real group is refused."""
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group exists; the fake one "
                               "is for dry runs in a process of their own")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    # private to torch's tests, and shipped with every build since 2.1
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _device_type(device: DeviceLike) -> str:
    """The mesh's device type: CUDA by default.  Over the fake group (a
    dry run) CUDA needs no card: the mesh models the card's collectives
    (DTensor moves a split from one dimension to another with an
    all-to-all there, and with a whole all-gather on a CPU mesh)."""
    if dist.is_initialized() and dist.get_backend() == "fake":
        return torch.device("cuda" if device is None else device).type
    return resolve_device(device).type


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device: DeviceLike = None):
    """Elastic-scaling entry point: any (data, model[, pod]) factorisation
    whose product matches the process group's world size."""
    from torch.distributed.device_mesh import init_device_mesh
    kind = _device_type(device)
    world = dist.get_world_size()
    n = 1
    for s in shape:
        n *= s
    if n != world:
        raise ValueError(f"a {shape} mesh needs {n} ranks, the process "
                         f"group has {world}")
    return init_device_mesh(kind, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 512 if multi_pod else 256
    _device_type(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise RuntimeError(
            f"the {'multi' if multi_pod else 'single'}-pod mesh {shape} "
            f"needs {n} ranks and the process group has {world}; run "
            f"launch.dryrun --mesh for these meshes (init_fake), or "
            f"--mesh host")
    return make_mesh(shape, axes, device)


def make_host_mesh(device: DeviceLike = None):
    """(1, world) mesh, axes ("data", "model"), over every rank of the
    process group (a 1x1 mesh on one)."""
    return make_mesh((1, dist.get_world_size()), ("data", "model"), device)
