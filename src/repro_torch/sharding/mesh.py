"""Named mesh axes over a ``torch.distributed`` world, and the collectives
along them.

A ``Mesh`` names the axes of the running world, ``("data", "model")`` (or
``("pod", "data", "model")``), with their sizes in ``mesh.shape`` as JAX's
``Mesh.shape`` gives them, and holds one process group per axis: the
ranks that share this rank's coordinates on every other axis.  Ranks lay
out row-major over the axes, as JAX's ``make_mesh`` lays out devices, so
rank ``r`` of a ``(data, model)`` mesh sits at ``(r // model, r % model)``.
``repro_torch.launch.mesh`` joins the world and builds meshes over it.

The collectives (``all_reduce``, ``all_gather``, ``pmean``) take a mesh
axis's group.  Under gloo a CUDA tensor is copied to the host, reduced
there and copied back, so two ranks can share one card (NCCL refuses
that).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}


class MeshError(RuntimeError):
    """A mesh that the running world cannot hold."""


class Mesh:
    """Named axes over the ranks of the default process group.

    ``shape`` maps each axis name to its size, ``coords`` this rank's
    index on each axis, ``groups`` each axis to the process group of the
    ranks that differ from this one on that axis alone.  A mesh made with
    ``groups=None`` describes a layout without a world (the partition
    arithmetic needs no more); its collectives raise."""

    def __init__(self, sizes, axis_names, *, rank: int = 0, groups=None):
        sizes, axis_names = tuple(sizes), tuple(axis_names)
        if len(sizes) != len(axis_names) or any(s < 1 for s in sizes):
            raise MeshError(f"mesh sizes {sizes} do not fit the axes "
                            f"{axis_names}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, sizes))
        self.size = math.prod(sizes)
        self.rank = rank
        coords, r = [], rank
        for s in reversed(sizes):
            coords.append(r % s)
            r //= s
        self.coords = dict(zip(axis_names, reversed(coords)))
        self.groups = groups

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank})"

    def group(self, axis: str):
        if self.groups is None:
            raise MeshError(f"{self!r} holds no process groups")
        return self.groups[axis]


def _staged(t: torch.Tensor, group):
    """The tensor to hand the backend: a host copy of a CUDA tensor under
    gloo, else ``t`` itself."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        return t.cpu()
    return t


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The elementwise ``op`` (``"sum"``, ``"max"`` or ``"min"``) of ``t``
    over the ranks of ``group``, as a new tensor on ``t``'s device."""
    buf = _staged(t, group)
    buf = buf.clone() if buf is t else buf
    dist.all_reduce(buf, op=_REDUCE_OPS[op], group=group)
    return buf.to(t.device)


def all_gather(t: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in group-rank order
    (``all_gather(..., tiled=True)`` in JAX)."""
    buf = _staged(t, group).contiguous()
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, buf, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def pmean(t: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``t`` over ``group``: a sum divided by the group's size
    (gloo has no averaging reduction)."""
    return all_reduce(t, group) / dist.get_world_size(group)
