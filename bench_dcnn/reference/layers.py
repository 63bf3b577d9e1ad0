"""One layer of the networks, channels-last, as the configuration files
describe them.

Activations are ``[N, *spatial, C]`` and weights ``[*K, Cin, Cout]``.
``conv`` is a correlation (no kernel flip) over the input padded by
``(lo, hi)`` per dim; ``deconv`` is the transposed convolution
``y[i*s + k] += x[i] w[k]`` over the full extent ``(i - 1) s + k``,
then cropped by ``(lo, hi)`` per dim.  Both run as PyTorch's own
convolutions on operands rounded to ``precision``
(``numerics.operand``), accumulating in float32."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bench_dcnn.reference.numerics import operand, product

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _channels_first(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(-1, 1)


def _channels_last(y: torch.Tensor) -> torch.Tensor:
    return y.movedim(1, -1).contiguous()


def conv(x, w, stride, padding, precision: str = "f32") -> torch.Tensor:
    rank = x.dim() - 2
    x = operand(x, precision)
    w = operand(w, precision)
    pads = []
    for lo, hi in reversed(padding):
        pads += [lo, hi]
    xc = F.pad(_channels_first(x), pads)
    wc = w.permute(rank + 1, rank, *range(rank))        # [Cout, Cin, *K]
    return product(_channels_last(_CONV[rank](xc, wc, stride=tuple(stride))),
                   precision)


def deconv(x, w, stride, crop, precision: str = "f32") -> torch.Tensor:
    rank = x.dim() - 2
    x = operand(x, precision)
    w = operand(w, precision)
    wc = w.permute(rank, rank + 1, *range(rank))        # [Cin, Cout, *K]
    y = _CONV_T[rank](_channels_first(x), wc, stride=tuple(stride))
    cut = tuple(slice(lo, y.shape[2 + d] - hi)
                for d, (lo, hi) in enumerate(crop))
    return product(_channels_last(y[(slice(None), slice(None), *cut)]),
                   precision)


def matmul(x, w, precision: str = "f32") -> torch.Tensor:
    return product(operand(x, precision) @ operand(w, precision), precision)


def epilogue(y, bias=None, activation: str = "none", alpha: float = 0.2):
    if bias is not None:
        y = y + bias.to(torch.float32)
    if activation == "relu":
        return torch.relu(y)
    if activation == "leaky_relu":
        return F.leaky_relu(y, alpha)
    if activation == "tanh":
        return torch.tanh(y)
    if activation != "none":
        raise ValueError(f"unknown activation {activation!r}")
    return y


def out_spatial(op: str, in_spatial, kernel, stride, padding):
    if op == "deconv":
        return tuple((i - 1) * s + k - lo - hi for i, k, s, (lo, hi)
                     in zip(in_spatial, kernel, stride, padding))
    return tuple((i + lo + hi - k) // s + 1 for i, k, s, (lo, hi)
                 in zip(in_spatial, kernel, stride, padding))


def apply(layer: dict, x, w, b=None, precision: str = "f32"):
    """Run one layer description (``op``, ``stride``, ``padding``,
    ``activation``) on ``x``."""
    op = conv if layer["op"] == "conv" else deconv
    y = op(x, w, layer["stride"], layer["padding"], precision)
    return epilogue(y, b, layer.get("activation", "none"),
                    layer.get("alpha", 0.2))
