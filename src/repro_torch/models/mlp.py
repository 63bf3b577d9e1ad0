"""Dense MLP blocks (JAX ``models/mlp.py``): gated (SwiGLU-family) and
plain (GELU / squared-ReLU).

On a mesh with a ``model`` axis whose extent divides ``d_ff``, ``w_in``
and ``w_gate`` are column-parallel and ``w_out`` row-parallel: each rank
holds its block of the hidden dim and the output is summed over the
axis with one all-reduce.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.sharding import mesh as _mesh
from repro_torch.sharding.partition import current_mesh

MODEL = ("model",)


class MlpParams(NamedTuple):
    w_in: torch.Tensor              # [D, F]
    w_gate: torch.Tensor | None     # [D, F] (gated only)
    w_out: torch.Tensor             # [F, D]


def init_mlp(generator: torch.Generator, cfg: ModelConfig, device="cuda",
             d_model=None, d_ff=None, gated=None,
             stack: tuple[int, ...] = (), dtype=torch.float32) -> MlpParams:
    """One MLP's weights, or ``stack`` of them stacked in front (the
    reference's ``[L, ...]`` leaves); each drawn at its own fan-in and
    cast to ``dtype``."""
    d = d_model or cfg.d_model
    f = d_ff or cfg.d_ff
    gated = cfg.gated_mlp if gated is None else gated

    def w(shape, logical):
        return L.dense_init(generator, (*stack, *shape),
                            scale=1.0 / math.sqrt(shape[0]), dtype=dtype,
                            device=device, logical=logical)

    col = ("fsdp", "model")
    return MlpParams(w_in=w((d, f), col),
                     w_gate=w((d, f), col) if gated else None,
                     w_out=w((f, d), ("model", "fsdp")))


def mlp(p: MlpParams, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    act = L.activation(cfg.mlp_activation)
    mesh = current_mesh() if p.w_in.shape[-1] != cfg.d_ff else None
    x = _mesh.copy_to(x, mesh, MODEL)

    def core(x, w_in, w_gate):
        h = x @ w_in.to(x.dtype)
        if w_gate is not None:
            return act(x @ w_gate.to(x.dtype)) * h
        return act(h)

    y = L.blk_out(cfg, core, (x, p.w_in, p.w_gate), p.w_out.to(x.dtype))
    return _mesh.reduce_from(y, mesh, MODEL, "blk_out")
