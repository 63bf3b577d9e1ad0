"""Dense MLP blocks (JAX ``models/mlp.py``): gated (SwiGLU-family) and
plain (GELU / squared-ReLU)."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


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

    def w(shape):
        return L.dense_init(generator, (*stack, *shape),
                            scale=1.0 / math.sqrt(shape[0]), dtype=dtype,
                            device=device)

    return MlpParams(w_in=w((d, f)), w_gate=w((d, f)) if gated else None,
                     w_out=w((f, d)))


def mlp(p: MlpParams, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    act = L.activation(cfg.mlp_activation)
    h = x @ p.w_in.to(x.dtype)
    if p.w_gate is not None:
        h = act(x @ p.w_gate.to(x.dtype)) * h
    else:
        h = act(h)
    return h @ p.w_out.to(x.dtype)
