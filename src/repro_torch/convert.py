"""Carry weight trees between the JAX package and the port.

The two packages share their layouts (weights ``[*K, Cin/G, Cout]``,
name-keyed dicts of bare arrays or ``{"w", "b"}`` entries for graphs,
lists for chains), so crossing over is a structural map.  The JAX side
hands over ``jax.tree_util.tree_map(np.asarray, weights)``; this module
turns it into tensors on a device and refuses any entry whose shape does
not match its layer.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import networks as _networks
from repro_torch.core.engine import ScheduleError


class WeightShapeError(ScheduleError):
    """A weight tree does not match the network it is meant for."""


def _tensor(a, device, dtype):
    a = np.array(a, copy=True, order="C")   # JAX hands out read-only views
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16 from JAX
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def _entry_shapes(entry):
    if isinstance(entry, dict):
        return tuple(entry["w"].shape), (None if entry.get("b") is None
                                         else tuple(entry["b"].shape))
    return tuple(entry.shape), None


def check_weights(network, ws) -> None:
    """Raise ``WeightShapeError`` unless ``ws`` fits ``network`` (a
    ``UniformGraph`` with a name-keyed dict, or a layer chain with a list):
    every layer has an entry, each ``w`` has the layer's ``weight_shape``,
    and each bias is ``(cout,)`` and present where the epilogue needs it."""
    if isinstance(network, _networks.UniformGraph):
        layers = network.layers
        if not isinstance(ws, dict):
            raise WeightShapeError(f"a graph takes a name-keyed dict of "
                                   f"weights, got {type(ws).__name__}")
        missing = [l.name for l in layers if l.name not in ws]
        if missing:
            raise WeightShapeError(f"weights missing entries for {missing}")
        entries = [ws[l.name] for l in layers]
    else:
        layers = list(network)
        if len(ws) != len(layers):
            raise WeightShapeError(f"expected {len(layers)} weight entries, "
                                   f"got {len(ws)}")
        entries = list(ws)
    for layer, entry in zip(layers, entries):
        w_shape, b_shape = _entry_shapes(entry)
        if w_shape != layer.weight_shape:
            raise WeightShapeError(
                f"layer {layer.name!r}: weight shape {w_shape} != "
                f"{layer.weight_shape}")
        if layer.epilogue.bias and b_shape != (layer.cout,):
            raise WeightShapeError(
                f"layer {layer.name!r}: bias shape {b_shape} != "
                f"{(layer.cout,)}")


def weights_from_numpy(tree, device, dtype: torch.dtype | None = None, *,
                       network):
    """The JAX package's weight tree (as numpy arrays) -> the port's tree of
    tensors on ``device`` (cast to ``dtype`` when given), checked against
    ``network`` with ``check_weights``."""
    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [convert(v) for v in node]
        return _tensor(node, device, dtype)

    out = convert(tree)
    check_weights(network, out)
    return out
