"""The one int8 round/clip/scale codepath of the port (JAX
``quant/qint8.py``).

Everything in the port that quantizes to int8 (the weight calibration and
the engine's dynamic activation quantization) goes through these helpers,
so the numerics are defined once.  The scheme is symmetric absmax int8:
``scale = absmax / 127`` and ``q = clip(round(x / scale), -127, 127)``;
``torch.round`` rounds half to even, as ``jnp.round`` does, so both
packages give the same integers.  ``dequantize_int8`` is the inverse up to
rounding: ``q * scale``.  Every helper is plain tensor code and runs on the
tensor's device without a host sync.
"""

from __future__ import annotations

import torch

# quantized values live in [-127, 127]; -128 is never produced so the
# range is symmetric and negation is exact
QMAX = 127.0
# scales are floored here so an all-zero tensor quantizes to zeros
# instead of dividing by zero
SCALE_FLOOR = 1e-12


def absmax_scale(x: torch.Tensor, axis: int | None = None) -> torch.Tensor:
    """Symmetric absmax scale(s) of ``x``, f32.

    ``axis=None`` gives one per-tensor scalar (a 0-dim tensor); an integer
    axis gives per-channel scales over that axis, shape
    ``(x.shape[axis],)``.
    """
    ax = x.abs()
    if axis is None:
        amax = ax.amax()
    else:
        axis = axis % x.dim()
        amax = ax.amax(dim=tuple(a for a in range(x.dim()) if a != axis))
    return (amax.clamp_min(SCALE_FLOOR) / QMAX).to(torch.float32)


def quantize_q8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Round/clip ``x`` to int8 under a given (broadcastable) scale."""
    return torch.clamp(torch.round(x / scale), -QMAX, QMAX).to(torch.int8)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor absmax int8: returns ``(q, scale)``."""
    scale = absmax_scale(x)
    return quantize_q8(x, scale), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_q8` up to rounding: ``q * scale``."""
    return q.to(torch.float32) * scale
