"""int8 gradient compression for the data-parallel all-reduce, with error
feedback (JAX ``optim/compress.py``).

Each rank quantizes its local gradient to int8 with a per-tensor absmax
scale (``repro_torch.quant.qint8``, the engine's numerics), the int8
payloads are summed as int32 (an int8 sum would overflow), the scales
reduced to their maximum, and the sum dequantized with the maximum scale
over the group's size: the mean.  Error feedback keeps each rank's
quantization residual on that rank and adds it to its next gradient, so
the bias vanishes over steps.

``group`` is the process group of the mesh's data axis
(``mesh.group("data")``); the collectives are ``sharding.mesh``'s, which
stage CUDA tensors through the host under gloo.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import tree as _tree
from repro_torch.sharding import mesh as _mesh
from repro_torch.quant.qint8 import (  # noqa: F401 (re-export)
    dequantize_int8,
    quantize_int8,
)


def _reduce_q(q: torch.Tensor, scale: torch.Tensor, group) -> torch.Tensor:
    """The group's mean of ``q * scale`` as the int8 wire computes it."""
    total = _mesh.all_reduce(q.to(torch.int32), group)
    max_scale = _mesh.all_reduce(scale, group, op="max")
    n = float(dist.get_world_size(group))
    return total.to(torch.float32) * max_scale / n


def psum_int8(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce-MEAN of ``x`` over ``group`` through int8: quantized,
    then summed as int32, so the collective carries 4 B per element as
    f32's would (the reference's wire accounting models an int8 ring)."""
    q, scale = quantize_int8(x)
    return _reduce_q(q, scale, group)


def psum_int8_tree(grads, group, error_state=None):
    """Compressed mean-all-reduce over a gradient tree with error feedback.
    Returns ``(reduced_grads, new_error_state)``; the error state is this
    rank's and never leaves it."""
    if error_state is None:
        error_state = _tree.tree_map(
            lambda g: torch.zeros_like(g, dtype=torch.float32), grads)
    reduced, errors = [], []
    for g, e in zip(_tree.leaves(grads), _tree.leaves(error_state)):
        g32 = g.to(torch.float32) + e
        q, scale = quantize_int8(g32)
        errors.append(g32 - dequantize_int8(q, scale))
        reduced.append(_reduce_q(q, scale, group))
    return (_tree.unflatten(grads, reduced),
            _tree.unflatten(error_state, errors))
