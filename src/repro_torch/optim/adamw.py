"""AdamW with optional 8-bit moment quantization (JAX ``optim/adamw.py``).

8-bit states (per-tensor symmetric int8 with an f32 scale) cut optimizer
memory 4x.  Moments are dequantised, updated in f32 and re-quantised every
step.  The update is functional, as in the JAX package: it returns new
parameter and state trees and leaves its inputs untouched.

A partitioned leaf's 8-bit scale is the whole tensor's: ``adamw_update``
takes ``absmax``, one function per leaf that turns the rank's block
maximum into the whole tensor's (a MAX all-reduce over the axes that
shard it; ``launch.steps`` builds them), and every rank holds the same
scale, replicated as ``opt_shardings`` lays it out.  f32 moments are
elementwise and need nothing.

The update runs a leaf at a time, in slices of at most ``_SLICE``
elements, so its f32 transients stay a slice's size whatever the leaf's
(an 8-bit leaf's moments are computed twice: once for the whole
tensor's maximum, once for the codes).  Every element's arithmetic is
the same as on the whole leaf, so the result is bit for bit the same.
A train step that owns its gradients hands them over as a list with
``consume=True``: each is dropped once its leaf is updated.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch import tree as _tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    state_bits: int = 32      # 32 | 8


class QTensor(NamedTuple):
    q: torch.Tensor        # int8 payload
    scale: torch.Tensor    # f32 scalar


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Any                 # tree of f32 tensors or QTensors
    v: Any


# elements of a leaf one slice of the update holds
_SLICE = 1 << 24


def _scale(amax: torch.Tensor, absmax=None) -> torch.Tensor:
    """The int8 scale of a tensor whose absolute maximum is ``amax`` (the
    whole tensor's through ``absmax`` where it is a block of a partitioned
    one)."""
    if absmax is not None:
        amax = absmax(amax)
    return torch.clamp(amax, min=1e-12) / 127.0


def _codes(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def _quant(x: torch.Tensor, absmax=None) -> QTensor:
    """``x`` as int8 with one scale, from its absolute maximum."""
    scale = _scale(x.abs().max(), absmax)
    return QTensor(_codes(x, scale), scale.to(torch.float32))


def _is_q(x) -> bool:
    return isinstance(x, QTensor)


def adamw_init(params, opt: AdamWConfig) -> AdamWState:
    def zero_like(p):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return _quant(z) if opt.state_bits == 8 else z
    leaves = _tree.leaves(params)
    device = leaves[0].device if leaves else "cpu"
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=_tree.tree_map(zero_like, params),
                      v=_tree.tree_map(zero_like, params))


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, opt: AdamWConfig,
                 lr_scale=1.0, absmax=None, consume: bool = False):
    """Returns (new_params, new_state).  Master weights stay in the dtype
    they are stored in (f32 recommended); update math is f32.
    ``absmax`` (a list, one entry per leaf, ``None`` for a whole leaf)
    gives a partitioned leaf's 8-bit scale its whole tensor's maximum.
    With ``consume``, ``grads`` is a list of the gradient leaves, each
    set to ``None`` once its leaf is updated."""
    step = state.step + 1
    b1, b2 = opt.b1, opt.b2
    bc1 = 1.0 - b1 ** step.to(torch.float32)
    bc2 = 1.0 - b2 ** step.to(torch.float32)
    lr = opt.lr * lr_scale

    def part(t, sl):
        """Slice ``sl`` of a moment's flat f32 values."""
        if _is_q(t):
            return t.q.reshape(-1)[sl].to(torch.float32) * t.scale
        return t.reshape(-1)[sl]

    def upd(p, g, m, v, amax):
        q8, n = _is_q(m), p.numel()
        slices = [slice(i, min(i + _SLICE, n)) for i in range(0, n, _SLICE)]
        flat_g = g.reshape(-1)

        def moments(sl):
            gs = flat_g[sl].to(torch.float32)
            m_f = b1 * part(m, sl) + (1 - b1) * gs
            v_f = b2 * part(v, sl) + (1 - b2) * torch.square(gs)
            return m_f, v_f

        if q8:
            # the whole leaf's maxima first (a max is exact in any order)
            peak = torch.stack([torch.stack([t.abs().max()
                                             for t in moments(sl)])
                                for sl in slices]).amax(0)
            s_m, s_v = _scale(peak[0], amax), _scale(peak[1], amax)
        new_p = torch.empty(p.shape, dtype=p.dtype, device=p.device)
        m_o, v_o = (torch.empty(p.shape, device=p.device,
                                dtype=torch.int8 if q8 else torch.float32)
                    for _ in range(2))
        for sl in slices:
            m_f, v_f = moments(sl)
            m_hat = m_f / bc1
            v_hat = v_f / bc2
            delta = m_hat / (torch.sqrt(v_hat) + opt.eps)
            p32 = p.reshape(-1)[sl].to(torch.float32)
            new_p.view(-1)[sl] = (p32 - lr * (delta + opt.weight_decay
                                              * p32)).to(p.dtype)
            m_o.view(-1)[sl] = _codes(m_f, s_m) if q8 else m_f
            v_o.view(-1)[sl] = _codes(v_f, s_v) if q8 else v_f
        if q8:
            return (new_p, QTensor(m_o, s_m.to(torch.float32)),
                    QTensor(v_o, s_v.to(torch.float32)))
        return new_p, m_o, v_o

    flat_p = _tree.leaves(params)
    if consume and not isinstance(grads, list):
        raise TypeError("consume=True takes the gradient leaves as a list")
    flat_g = grads if consume else _tree.leaves(grads)
    flat_m = _tree.leaves(state.m, is_leaf=_is_q)
    flat_v = _tree.leaves(state.v, is_leaf=_is_q)
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError("params, grads and moments differ in structure")
    flat_a = [None] * len(flat_p) if absmax is None else list(absmax)
    if len(flat_a) != len(flat_p):
        raise ValueError("absmax differs from params in structure")
    out = []
    for i in range(len(flat_p)):
        out.append(upd(flat_p[i], flat_g[i], flat_m[i], flat_v[i],
                       flat_a[i]))
        if consume:
            flat_g[i] = None
    new_p = _tree.unflatten(params, [o[0] for o in out])
    new_m = _tree.unflatten(state.m, [o[1] for o in out], is_leaf=_is_q)
    new_v = _tree.unflatten(state.v, [o[2] for o in out], is_leaf=_is_q)
    return new_p, AdamWState(step=step, m=new_m, v=new_v)
