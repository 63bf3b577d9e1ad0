"""LR schedules (JAX ``optim/schedule.py``)."""

from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, warmup: int = 100, total: int = 10000,
                    min_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup over ``warmup`` steps, then a cosine decay to
    ``min_frac`` at ``total``: the reference's arithmetic in f32, on the
    device of ``step`` when it is a tensor.  Step 0 gives 0, so the first
    update of a run moves no parameter."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos
