"""Joining a ``torch.distributed`` world and building device meshes over
it (JAX ``launch/mesh.py``).

The ``Mesh`` itself and the collectives along its axes are
``repro_torch.sharding.mesh``'s; this module makes them over the running
world.  Building a mesh is collective: every rank of the default group
calls ``make_host_mesh`` (or ``make_production_mesh``) with the same
arguments, because ``dist.new_group`` must see every group created in the
same order on every rank.  The world comes first, from ``init_world``:
the backend is the caller's choice (``backend_for`` names ``"nccl"`` for
a CUDA device and ``"gloo"`` for the CPU); nothing here picks one on its
own.

``make_production_mesh(world=False)`` builds the production layouts
without a world, as rank 0 of them (``abstract_mesh``): the dry run
traces a step there on ``meta`` tensors (``sharding.mesh``).
"""

from __future__ import annotations

import datetime
import math
import os

import torch
import torch.distributed as dist

from repro_torch.sharding.mesh import AbstractGroup, Mesh, MeshError  # noqa: F401

HOST_AXES = ("data", "model")
# the reference's production meshes: one pod of 16 x 16 chips, two pods
PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def backend_for(device) -> str:
    """The collective backend for tensors on ``device``: ``"nccl"`` for a
    CUDA device, ``"gloo"`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_world(backend: str, *, init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None,
               timeout_s: float = 300.0) -> bool:
    """Join the default process group, unless this process already has;
    True when this call joined it (the caller then ``leave_world``s).

    With ``init_method`` the caller names the rendezvous (``file://`` or
    ``tcp://``), the world size and this rank.  Without it the world is
    the one ``torchrun`` describes (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``), or, when ``WORLD_SIZE`` is not set,
    a world of this process alone."""
    if dist.is_initialized():
        return False
    timeout = datetime.timedelta(seconds=timeout_s)
    if init_method is not None:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank,
                                timeout=timeout)
    elif "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=timeout)
    return True


def leave_world() -> None:
    """Destroy the default process group (and every group made over it)."""
    dist.destroy_process_group()


def _batch_axes(axis_names) -> tuple[str, ...]:
    """The batch axes that have a group of their own (FSDP, the
    data-parallel sums), where there are more than one."""
    batch = tuple(a for a in ("pod", "data") if a in axis_names)
    return batch if len(batch) > 1 else ()


def _make_mesh(sizes, axis_names) -> Mesh:
    if not dist.is_initialized():
        raise MeshError("no process group: call launch.mesh.init_world "
                        "first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if math.prod(sizes) != world:
        raise MeshError(f"a {'x'.join(map(str, sizes))} mesh needs "
                        f"{math.prod(sizes)} ranks; the world has {world}")
    layout = torch.arange(world).reshape(sizes)
    groups = {}
    for i, axis in enumerate(axis_names):
        # every line of ranks along this axis: every rank creates every
        # group, in the same order, and keeps the one it belongs to
        lines = layout.movedim(i, -1).reshape(-1, sizes[i])
        for line in lines.tolist():
            g = dist.new_group(line)
            if rank in line:
                groups[axis] = g
    batch = _batch_axes(axis_names)
    if batch:
        dims = [axis_names.index(a) for a in batch]
        lines = layout.movedim(dims, list(range(-len(dims), 0))).reshape(
            -1, math.prod(sizes[i] for i in dims))
        for line in lines.tolist():
            g = dist.new_group(line)
            if rank in line:
                groups[batch] = g
    return Mesh(sizes, axis_names, rank=rank, groups=groups)


def make_host_mesh(model: int = 1, data: int | None = None) -> Mesh:
    """The running world as a ``(data, model)`` mesh; ``data`` defaults to
    the world size over ``model``."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data is None:
        data = max(1, world // model)
    return _make_mesh((data, model), HOST_AXES)


def make_production_mesh(*, multi_pod: bool = False,
                         world: bool = True) -> Mesh:
    """The reference's 16 x 16 (one pod, 256 ranks) or 2 x 16 x 16 (two
    pods, 512 ranks) mesh; a world of another size raises ``MeshError``.
    ``world=False``: the layout without a world (``abstract_mesh``)."""
    sizes, axes = PRODUCTION_SHAPES[multi_pod]
    if not world:
        return abstract_mesh(sizes, axes)
    return _make_mesh(sizes, axes)


def abstract_mesh(sizes, axis_names=HOST_AXES) -> Mesh:
    """A mesh of ``sizes`` over ``axis_names`` without a world, as rank 0
    of it: its groups (each axis's, and the batch axes') are
    ``AbstractGroup``s, whose collectives take ``meta`` tensors only."""
    shape = dict(zip(axis_names, sizes))
    groups = {a: AbstractGroup((a,), n) for a, n in shape.items()}
    batch = _batch_axes(axis_names)
    if batch:
        groups[batch] = AbstractGroup(batch,
                                      math.prod(shape[a] for a in batch))
    return Mesh(sizes, axis_names, groups=groups)
