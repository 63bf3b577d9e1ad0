"""Carry weight trees between the JAX package and the port.

The two packages share their layouts (weights ``[*K, Cin/G, Cout]``,
name-keyed dicts of bare arrays, ``{"w", "b"}`` or quantized ``{"w_q",
"scale", "b"}`` entries for graphs, lists for chains), so crossing over is
a structural map.  The JAX side hands over
``jax.tree_util.tree_map(np.asarray, weights)``; this module turns it into
tensors on a device and refuses any entry whose shape does not match its
layer.  ``params_from_numpy`` does the same for a model's
parameter tree (``{"gen", "disc"}``, ``{"vnet"}``, or an LM's
``{"embed", "final_norm", "layers", ...}`` with its ``AttnParams``,
``MlpParams``, ``MoeParams``, ``MLstmParams``, ``SLstmParams`` and
``Mamba2Params``, xLSTM's layers a list) and ``adamw_state_from_numpy`` for its AdamW state.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree as _tree
from repro_torch.core import networks as _networks
from repro_torch.core.engine import ScheduleError
from repro_torch.launch.steps import _init_ws, param_specs
from repro_torch.models.attention import AttnParams
from repro_torch.models.mlp import MlpParams
from repro_torch.models.moe import MoeParams
from repro_torch.models.ssm import Mamba2Params, MLstmParams, SLstmParams
from repro_torch.optim.adamw import AdamWState, QTensor
from repro_torch.sharding.partition import shard_tree


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
    """(weight shape, bias shape or None, scale shape or None)."""
    if isinstance(entry, dict):
        w = entry["w_q"] if "w_q" in entry else entry["w"]
        return tuple(w.shape), *(
            None if entry.get(k) is None else tuple(entry[k].shape)
            for k in ("b", "scale"))
    return tuple(entry.shape), None, None


def check_weights(network, ws) -> None:
    """Raise ``WeightShapeError`` unless ``ws`` fits ``network`` (a
    ``UniformGraph`` with a name-keyed dict, or a layer chain with a list):
    every layer has an entry, each ``w`` (or quantized ``w_q``) has the
    layer's ``weight_shape``, each bias is ``(cout,)`` and present where
    the epilogue needs it, and each dequant scale is per-cout or one
    scalar."""
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
        w_shape, b_shape, s_shape = _entry_shapes(entry)
        if w_shape != layer.weight_shape:
            raise WeightShapeError(
                f"layer {layer.name!r}: weight shape {w_shape} != "
                f"{layer.weight_shape}")
        if layer.epilogue.bias and b_shape != (layer.cout,):
            raise WeightShapeError(
                f"layer {layer.name!r}: bias shape {b_shape} != "
                f"{(layer.cout,)}")
        if s_shape not in (None, (), (1,), (layer.cout,)):
            raise WeightShapeError(
                f"layer {layer.name!r}: scale shape {s_shape} is neither "
                f"{(layer.cout,)} nor a scalar")


def weights_from_numpy(tree, device, dtype: torch.dtype | None = None, *,
                       network):
    """The JAX package's weight tree (as numpy arrays) -> the port's tree of
    tensors on ``device`` (float weights and biases cast to ``dtype`` when
    given; a quantized entry's ``w_q`` stays int8 and its ``scale`` f32),
    checked against ``network`` with ``check_weights``."""
    def convert(node, keep=False):
        if isinstance(node, dict):
            return {k: convert(v, keep or k in ("w_q", "scale"))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [convert(v) for v in node]
        return _tensor(node, device, None if keep else dtype)

    out = convert(tree)
    check_weights(network, out)
    return out


_NAMED = {cls._fields: cls
          for cls in (QTensor, AdamWState, AttnParams, MlpParams, MoeParams,
                      MLstmParams, SLstmParams, Mamba2Params)}


def _tree_from_numpy(node, device, dtype):
    """Nested dicts/lists/NamedTuples of arrays -> the same of tensors
    (NamedTuples of the JAX package become the port's by field names;
    ``None``, a plain MLP's absent gate, stays ``None``)."""
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _tree_from_numpy(v, device, dtype) for k, v in node.items()}
    if hasattr(node, "_fields"):
        kids = {f: _tree_from_numpy(getattr(node, f), device, dtype)
                for f in node._fields}
        kind = _NAMED.get(tuple(node._fields))
        if kind is None:
            raise WeightShapeError(f"unknown tree node {type(node).__name__}"
                                   f"{node._fields}")
        return kind(**kids)
    if isinstance(node, (list, tuple)):
        return type(node)(_tree_from_numpy(v, device, dtype) for v in node)
    return _tensor(node, device, dtype)


def _shapes(node):
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _shapes(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_shapes(v) for v in node]
    return tuple(node.shape)


def _check_like(got, want, what: str) -> None:
    if _shapes(got) != _shapes(want):
        raise WeightShapeError(f"{what} do not match the model: "
                               f"{_shapes(got)} != {_shapes(want)}")


def params_from_numpy(tree, device, dtype: torch.dtype | None = None, *,
                      cfg, mesh=None):
    """A model's parameter tree from the JAX package (``{"gen", "disc"}``,
    ``{"vnet"}`` or an LM's, as numpy arrays) -> tensors on ``device``,
    checked leaf for leaf against the shapes ``launch.steps.real_params(
    cfg, ...)`` gives; with ``mesh``, each leaf this rank's block
    (``launch.steps.param_specs``)."""
    out = _tree_from_numpy(tree, device, dtype)
    _check_like(out, _init_ws(cfg, None, device="meta"), "params")
    if mesh is None:
        return out
    return _tree.tree_map(torch.Tensor.clone, shard_tree(
        out, param_specs(cfg, mesh), mesh))


def adamw_state_from_numpy(state, device, *, params):
    """An ``AdamWState`` of the JAX package (as numpy arrays, f32 or 8-bit
    ``QTensor`` moments) -> the port's, on ``device``; its moments are
    checked against ``params``."""
    out = _tree_from_numpy(state, device, None)
    for name in ("m", "v"):
        moments = _tree.tree_map(
            lambda m: m.q if isinstance(m, QTensor) else m,
            getattr(out, name), is_leaf=lambda x: isinstance(x, QTensor))
        _check_like(moments, params, f"AdamW moments {name}")
    return out
