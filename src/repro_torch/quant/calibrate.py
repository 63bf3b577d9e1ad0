"""Calibration: pick per-channel scales, quantize weight trees (JAX
``quant/calibrate.py``).

Two observers produce per-channel scales over the engine's weight layout
``(*kernel, cin, cout)`` (channel axis ``-1`` = per-cout, the only axis
whose dequant scale commutes with the ci/tap contraction):

* :func:`absmax_observer` — exact symmetric absmax per channel.
* :func:`percentile_observer` — clipped symmetric scale at the p-th
  percentile of |w| per channel, computed on the host (calibration is
  offline) through the port's one percentile implementation
  (``repro_torch.obs.quantile``).  Robust to the single outlier weight
  that would otherwise blow up the absmax step.

:func:`quantize_weights` walks the weight trees ``compile_network``
accepts (name-keyed graph dicts, chain lists, bare tensors or ``{"w",
"b"}`` entries) and replaces each float weight with a ``{"w_q": int8,
"scale": f32[cout]}`` entry the engine consumes directly.  Biases ride
along unquantized: the kernels add them to the f32 sum in the fused
epilogue.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.obs import quantile as _quantile
from repro_torch.quant import qint8 as _q8
from repro_torch.quant.precision import Precision

Observer = Callable[..., Any]


def absmax_observer(w: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Per-channel symmetric absmax scales, shape ``(w.shape[axis],)``."""
    return _q8.absmax_scale(w, axis=axis)


def percentile_observer(w: torch.Tensor, pct: float = 99.9,
                        axis: int = -1) -> torch.Tensor:
    """Per-channel scales clipped at the ``pct``-th percentile of |w|,
    on ``w``'s device."""
    aw = w.detach().to("cpu", torch.float32).abs().numpy()
    aw = np.moveaxis(aw, axis % aw.ndim, -1).reshape(-1, aw.shape[axis])
    scales = [
        max(_quantile(sorted(aw[:, c].tolist()), pct), float(_q8.SCALE_FLOOR))
        / _q8.QMAX
        for c in range(aw.shape[1])
    ]
    return torch.tensor(scales, dtype=torch.float32, device=w.device)


_OBSERVERS: dict[str, Observer] = {
    "absmax": absmax_observer,
    "percentile": percentile_observer,
}


def quantize_tensor(w: torch.Tensor, *, axis: int = -1,
                    observer: str | Observer = "absmax") -> dict:
    """Quantize one weight tensor -> ``{"w_q": int8, "scale": f32}``."""
    if callable(observer):
        obs_fn = observer
    else:
        try:
            obs_fn = _OBSERVERS[observer]
        except KeyError:
            raise ValueError(
                f"unknown observer {observer!r}; choose from "
                f"{tuple(_OBSERVERS)}") from None
    scale = obs_fn(w, axis=axis)
    return {"w_q": _q8.quantize_q8(w, scale), "scale": scale}


def _quantize_entry(entry, axis, observer):
    if isinstance(entry, Mapping):
        if "w_q" in entry:
            return dict(entry)  # already quantized
        out = quantize_tensor(entry["w"], axis=axis, observer=observer)
        if entry.get("b") is not None:
            out["b"] = entry["b"]
        return out
    return quantize_tensor(entry, axis=axis, observer=observer)


def quantize_weights(params, precision: Precision, *,
                     observer: str | Observer = "absmax"):
    """Quantize a ``compile_network`` weight tree under ``precision``.

    Accepts what ``compile_network`` does — a name-keyed graph dict
    (values a bare weight or ``{"w", "b"}``) or a chain sequence — and
    returns the same structure with every float weight replaced by a
    ``{"w_q", "scale"}`` entry (bias kept).  A policy without weight
    quantization returns ``params`` unchanged.
    """
    if precision.weight_quant == "none":
        return params
    axis = precision.channel_axis
    if isinstance(params, Mapping):
        return {name: _quantize_entry(entry, axis, observer)
                for name, entry in params.items()}
    if isinstance(params, Sequence):
        return [_quantize_entry(entry, axis, observer) for entry in params]
    return _quantize_entry(params, axis, observer)
