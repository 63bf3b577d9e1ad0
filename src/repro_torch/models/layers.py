"""Parameter initialisers of the DCNN models (JAX ``models/layers.py``).

Weights are drawn from an explicit ``torch.Generator`` on the CPU and then
moved to ``device``; the JAX package's logical sharding axes have no
counterpart on one card.  ``device="meta"`` gives shapes without drawing.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def dense_init(generator: torch.Generator, shape: Sequence[int],
               scale: float | None = None, dtype=torch.float32,
               device="cuda") -> torch.Tensor:
    """Normal(0, scale) weights; ``scale`` defaults to 1/sqrt(fan_in)."""
    shape = tuple(shape)
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    fan_in = shape[0] if len(shape) > 1 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    v = torch.randn(shape, generator=generator, dtype=dtype) * scale
    return v.to(device)


def zeros_init(shape: Sequence[int], dtype=torch.float32,
               device="cuda") -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype, device=device)
