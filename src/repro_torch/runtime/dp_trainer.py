"""Explicit data-parallel trainer with an int8-compressed gradient
all-reduce and error feedback (JAX ``runtime/dp_trainer.py``).

Every rank of the mesh's data axis holds the whole model, runs the step on
its shard of the batch and reduces its gradients explicitly
(``reduce_grads``): quantized to int8 with error feedback and summed as
int32, or an f32 mean.
DDP's bucketed f32 mean is not the int8 wire format, so it is not used.
Params and optimizer state stay identical on every rank, since every rank
applies the same reduced gradients.

The error-feedback residual is per-rank state.  It keeps the JAX
package's leading ``[n_data]`` axis, so error trees cross between the
packages: each rank reads and writes its own row (``unstack_error`` /
``stack_error``) and leaves the others as they are.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch import tree as _tree
from repro_torch.sharding import mesh as _mesh
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.optim.compress import psum_int8_tree


def init_error_state(params, n_data: int):
    return _tree.tree_map(
        lambda p: torch.zeros((n_data, *p.shape), dtype=torch.float32,
                              device=p.device), params)


def reduce_grads(grads, err, group, compress: bool = True):
    """Mean-all-reduce a gradient tree over ``group``: through int8 with
    error feedback when ``compress``, an f32 mean otherwise.
    Returns ``(reduced_grads, new_error_state)``; the error state passes
    through untouched on the f32 path."""
    if compress:
        return psum_int8_tree(grads, group, err)
    return _tree.tree_map(lambda g: _mesh.pmean(g, group), grads), err


def unstack_error(err, index: int):
    """This rank's row of the ``[n_data, ...]`` error tree."""
    return _tree.tree_map(lambda e: e[index], err)


def stack_error(err, rows, index: int):
    """Write this rank's ``rows`` back into the ``[n_data, ...]`` error
    tree (in place) and return it."""
    for e, r in zip(_tree.leaves(err), _tree.leaves(rows)):
        e[index].copy_(r)
    return err


def make_dp_step(local_step: Callable, mesh, *, axis_name: str = "data"):
    """Wrap a data-parallel local step in the trainer's layout.

    ``local_step(params, opt_state, err, batch)`` runs on this rank's batch
    shard with ``err`` its own row, and returns ``(params, opt_state,
    err, metrics)``.  The returned step takes and returns the whole
    ``[n_data, ...]`` error tree."""
    index = mesh.coords[axis_name]

    def step(params, opt_state, err, batch):
        params, opt_state, rows, metrics = local_step(
            params, opt_state, unstack_error(err, index), batch)
        return params, opt_state, stack_error(err, rows, index), metrics

    return step


def grad_wire_bytes(params, compress: bool = True) -> dict:
    """Per-step gradient all-reduce bytes as the reference models them,
    from the param tree: the f32 gradient tree a rank contributes against
    an int8 wire (1 B per element and one f32 scale per leaf when
    ``compress``).  ``psum_int8`` sums int32, so what the port hands the
    collective is 4 B per element either way."""
    leaves = _tree.leaves(params)
    n = sum(int(l.numel()) for l in leaves)
    grads_bytes = 4 * n
    wire_bytes = (sum(int(l.numel()) + 4 for l in leaves) if compress
                  else grads_bytes)
    return {
        "param_count": n,
        "grads_bytes": grads_bytes,
        "collective_bytes": wire_bytes,
        "compress_ratio": grads_bytes / wire_bytes,
    }


def record_dp_metrics(telemetry, params, *, compress: bool = True,
                      n_data: int = 1) -> dict:
    """Record the trainer's per-step wire accounting as gauges
    (``dp_grads_bytes``, ``dp_collective_bytes``, ``dp_compress_ratio``,
    ``dp_data_parallel``) and return it."""
    acct = grad_wire_bytes(params, compress)
    telemetry.gauge("dp_grads_bytes").set(acct["grads_bytes"])
    telemetry.gauge("dp_collective_bytes").set(acct["collective_bytes"])
    telemetry.gauge("dp_compress_ratio").set(acct["compress_ratio"])
    telemetry.gauge("dp_data_parallel").set(n_data)
    return acct


def make_dp_train_step(loss_fn: Callable, opt: AdamWConfig, mesh,
                       compress: bool = True):
    """``loss_fn(params, batch) -> scalar``.  Returns
    ``step(params, opt_state, err_state, batch) -> (params, opt_state,
    err_state, loss)``, ``batch`` this rank's shard, ``loss`` the mean over
    the data axis."""
    group = mesh.group("data")

    def local_step(params, opt_state, err, batch):
        with torch.enable_grad():
            p = _tree.tree_map(lambda t: t.detach().requires_grad_(True),
                               params)
            loss = loss_fn(p, batch)
            grads = _tree.unflatten(p, torch.autograd.grad(
                loss, _tree.leaves(p)))
        loss = _mesh.pmean(loss.detach(), group)
        grads, err = reduce_grads(grads, err, group, compress)
        new_params, new_opt = adamw_update(grads, opt_state, params, opt)
        return new_params, new_opt, err, loss

    return make_dp_step(local_step, mesh)
