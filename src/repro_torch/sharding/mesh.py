"""Named mesh axes over a ``torch.distributed`` world, and the collectives
along them.

A ``Mesh`` names the axes of the running world, ``("data", "model")`` (or
``("pod", "data", "model")``), with their sizes in ``mesh.shape`` as JAX's
``Mesh.shape`` gives them, and holds one process group per axis: the
ranks that share this rank's coordinates on every other axis.  Ranks lay
out row-major over the axes, as JAX's ``make_mesh`` lays out devices, so
rank ``r`` of a ``(data, model)`` mesh sits at ``(r // model, r % model)``.
``repro_torch.launch.mesh`` joins the world and builds meshes over it.

The collectives (``all_reduce``, ``all_gather``, ``reduce_scatter``,
``pmean``) take a mesh axis's group.  Under gloo a CUDA tensor is copied
to the host, reduced there and copied back, so two ranks can share one
card (NCCL refuses that).  gloo sums bf16 as bf16 (each addition rounds
to bf16, as NCCL's does), so nothing is staged through f32.  gloo has no
reduce-scatter in every PyTorch version: under gloo ``reduce_scatter``
is an ``all_reduce`` of the whole tensor of which the rank keeps its
block (the same sums, the whole tensor's bytes on the wire); NCCL runs
the real collective.

The model code names axes, not groups: ``psum``, ``gather`` and
``scatter_sum`` take the mesh and a tuple of axis names (the batch axes
``("pod", "data")`` are one group), and ``copy_to``, ``reduce_from``,
``gather_from`` and ``scale_grad`` are their autograd-aware forms, the
Megatron pairs: ``copy_to`` is the identity forward and an all-reduce
backward, ``reduce_from`` an all-reduce forward and the identity
backward, ``gather_from`` an all-gather forward and a reduce-scatter
backward.  Each axis-level call adds one to ``collective_stats()``'s
count of its op on its axes, with the bytes this rank hands the backend;
a ``tag`` names a kind of call apart (``"all_reduce_sum[blk_out]"``: the
blocks' out-projection sums).

A mesh without a world (``launch.mesh.abstract_mesh``, whose groups are
``AbstractGroup``s) traces a step abstractly, as rank 0 of the layout:
on a ``meta`` tensor each collective, plain or axis-level, returns a
``meta`` tensor of its result's shape and dtype and records ``(op,
axes, bytes)`` as an axis-level call over a world does (the plain ones
too, so that the dry run sees the DCNN's data-parallel sums); on a real
tensor it raises ``MeshError``, since no other rank holds data.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.sharding.partition import mesh_axes

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
    arithmetic needs no more); its collectives raise.  One whose groups
    are ``AbstractGroup``s traces them (``launch.mesh.abstract_mesh``)."""

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

    def group(self, axis):
        """The process group of one axis, or of a tuple of axes (one
        axis, or the batch axes ``("pod", "data")``)."""
        if self.groups is None:
            raise MeshError(f"{self!r} holds no process groups")
        if isinstance(axis, tuple):
            axis = axis[0] if len(axis) == 1 else axis
        return self.groups[axis]

    @property
    def batch_axes(self) -> tuple[str, ...]:
        """The axes the logical ``batch`` (and ``fsdp``) resolve to."""
        return mesh_axes(self)["batch"]


class AbstractGroup:
    """The process group of ``axes`` (``size`` ranks) in a mesh without a
    world: a collective over it traces (``trace``)."""

    def __init__(self, axes: tuple[str, ...], size: int):
        self.axes, self.size = tuple(axes), size

    def trace(self, op: str, t: torch.Tensor, shape) -> torch.Tensor:
        """``op`` on ``t`` over this group: recorded (unless the group is
        one rank), and a ``meta`` tensor of the result's ``shape``; a
        real ``t`` raises."""
        if t.device.type != "meta":
            raise MeshError(f"{op} over {self.axes} of a mesh without a "
                            f"world takes meta tensors only, not "
                            f"{t.device}")
        if self.size > 1:
            _record(op, self.axes, t)
        return torch.empty(tuple(shape), dtype=t.dtype, device="meta")


def _blocks_of(t: torch.Tensor, dim: int, n: int):
    """``t``'s shape with ``dim`` cut into ``n`` blocks (one block's)."""
    if t.shape[dim] % n:
        raise MeshError(f"dim {dim} of {tuple(t.shape)} does not divide "
                        f"into {n} blocks")
    shape = list(t.shape)
    shape[dim] //= n
    return shape


def _gathered(t: torch.Tensor, dim: int, n: int):
    shape = list(t.shape)
    shape[dim] *= n
    return shape


def _staged(t: torch.Tensor, group):
    """The tensor to hand the backend: a host copy of a CUDA tensor under
    gloo, else ``t`` itself."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        return t.cpu()
    return t


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The elementwise ``op`` (``"sum"``, ``"max"`` or ``"min"``) of ``t``
    over the ranks of ``group``, as a new tensor on ``t``'s device."""
    if isinstance(group, AbstractGroup):
        return group.trace(f"all_reduce_{op}", t, t.shape)
    buf = _staged(t, group)
    buf = buf.clone() if buf is t else buf
    dist.all_reduce(buf, op=_REDUCE_OPS[op], group=group)
    return buf.to(t.device)


def all_gather(t: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in group-rank order
    (``all_gather(..., tiled=True)`` in JAX)."""
    if isinstance(group, AbstractGroup):
        return group.trace("all_gather", t, _gathered(t, dim, group.size))
    buf = _staged(t, group).contiguous()
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, buf, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def pmean(t: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``t`` over ``group``: a sum divided by the group's size
    (gloo has no averaging reduction)."""
    n = (group.size if isinstance(group, AbstractGroup)
         else dist.get_world_size(group))
    return all_reduce(t, group) / n


def reduce_scatter(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The sum of ``t`` over ``group``, of which this rank keeps its block
    along ``dim`` (block ``i`` of ``n`` equal ones for group rank ``i``).
    Under gloo: an ``all_reduce`` and a slice."""
    if isinstance(group, AbstractGroup):
        return group.trace("reduce_scatter", t,
                           _blocks_of(t, dim, group.size))
    n = dist.get_world_size(group)
    if t.shape[dim] % n:
        raise MeshError(f"dim {dim} of {tuple(t.shape)} does not divide "
                        f"into {n} blocks")
    per, i = t.shape[dim] // n, dist.get_rank(group)
    if dist.get_backend(group) == "gloo":
        return all_reduce(t, group).narrow(dim, i * per, per).contiguous()
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((per, *src.shape[1:]), dtype=t.dtype, device=t.device)
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous()


# -- axis-level collectives, counted -----------------------------------------

_STATS: dict[tuple[str, tuple[str, ...]], list[int]] = {}


def collective_stats() -> dict:
    """``{(op, axes): (calls, bytes)}`` of the axis-level collectives since
    the last ``reset_collective_stats``: the bytes are what this rank
    handed the backend (a reduce-scatter's whole input)."""
    return {k: tuple(v) for k, v in _STATS.items()}


def reset_collective_stats() -> None:
    _STATS.clear()


def _record(op: str, axes: tuple[str, ...], t: torch.Tensor) -> None:
    entry = _STATS.setdefault((op, axes), [0, 0])
    entry[0] += 1
    entry[1] += t.numel() * t.element_size()


def axis_size(mesh, axes: tuple[str, ...]) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def axis_index(mesh, axes) -> int:
    """This rank's index along ``axes`` (row-major over several, as the
    group over them orders its ranks)."""
    axes = (axes,) if isinstance(axes, str) else axes
    k = 0
    for a in axes:
        k = k * mesh.shape[a] + mesh.coords[a]
    return k


def psum(t: torch.Tensor, mesh, axes: tuple[str, ...],
         op: str = "sum", tag: str | None = None) -> torch.Tensor:
    """``all_reduce`` over ``axes``; ``t`` itself where they hold one
    rank."""
    if axis_size(mesh, axes) == 1:
        return t
    name = f"all_reduce_{op}" + (f"[{tag}]" if tag else "")
    group = mesh.group(axes)
    if isinstance(group, AbstractGroup):
        return group.trace(name, t, t.shape)
    _record(name, axes, t)
    return all_reduce(t, group, op)


def gather(t: torch.Tensor, mesh, axes: tuple[str, ...],
           dim: int) -> torch.Tensor:
    if axis_size(mesh, axes) == 1:
        return t
    group = mesh.group(axes)
    if not isinstance(group, AbstractGroup):    # which records itself
        _record("all_gather", axes, t)
    return all_gather(t, group, dim)


def scatter_sum(t: torch.Tensor, mesh, axes: tuple[str, ...],
                dim: int) -> torch.Tensor:
    if axis_size(mesh, axes) == 1:
        return t
    group = mesh.group(axes)
    if not isinstance(group, AbstractGroup):    # which records itself
        _record("reduce_scatter", axes, t)
    return reduce_scatter(t, group, dim)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.mesh, ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, tag):
        return psum(x, mesh, axes, tag=tag)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return scatter_sum(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def copy_to(x: torch.Tensor, mesh, axes: tuple[str, ...]) -> torch.Tensor:
    """``x`` (replicated over ``axes``) entering work that each rank does
    on its own part: the identity, whose backward sums the ranks' partial
    gradients."""
    if mesh is None or axis_size(mesh, axes) == 1:
        return x
    return _CopyTo.apply(x, mesh, axes)


def reduce_from(x: torch.Tensor, mesh, axes: tuple[str, ...],
                tag: str | None = None) -> torch.Tensor:
    """The sum of the ranks' partial ``x`` over ``axes``, whose backward
    hands each rank the whole gradient."""
    if mesh is None or axis_size(mesh, axes) == 1:
        return x
    return _ReduceFrom.apply(x, mesh, axes, tag)


def gather_from(x: torch.Tensor, mesh, axes: tuple[str, ...],
                dim: int) -> torch.Tensor:
    """The ranks' blocks of ``x`` concatenated along ``dim``, whose
    backward reduce-scatters (sums) the gradient back to the blocks."""
    if mesh is None or axis_size(mesh, axes) == 1:
        return x
    return _GatherFrom.apply(x, mesh, axes, dim)


def scale_grad(x: torch.Tensor, s: float) -> torch.Tensor:
    """The identity, whose backward scales the gradient by ``s``: a value
    that every rank of a ``copy_to`` region computes whole takes ``1 /
    n`` of its gradient on each, so that the region's sum is one."""
    if s == 1:
        return x
    return _ScaleGrad.apply(x, s)
