"""AdamW with optional 8-bit moment quantization (JAX ``optim/adamw.py``).

8-bit states (per-tensor symmetric int8 with an f32 scale) cut optimizer
memory 4x.  Moments are dequantised, updated in f32 and re-quantised every
step.  The update is functional, as in the JAX package: it returns new
parameter and state trees and leaves its inputs untouched.
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


def _quant(x: torch.Tensor) -> QTensor:
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return QTensor(q, scale.to(torch.float32))


def _dequant(t: QTensor) -> torch.Tensor:
    return t.q.to(torch.float32) * t.scale


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
                 lr_scale=1.0):
    """Returns (new_params, new_state).  Master weights stay in the dtype
    they are stored in (f32 recommended); update math is f32."""
    step = state.step + 1
    b1, b2 = opt.b1, opt.b2
    bc1 = 1.0 - b1 ** step.to(torch.float32)
    bc2 = 1.0 - b2 ** step.to(torch.float32)
    lr = opt.lr * lr_scale

    def upd(p, g, m, v):
        g = g.to(torch.float32)
        m_f = _dequant(m) if _is_q(m) else m
        v_f = _dequant(v) if _is_q(v) else v
        m_f = b1 * m_f + (1 - b1) * g
        v_f = b2 * v_f + (1 - b2) * torch.square(g)
        m_hat = m_f / bc1
        v_hat = v_f / bc2
        delta = m_hat / (torch.sqrt(v_hat) + opt.eps)
        p32 = p.to(torch.float32)
        new_p = p32 - lr * (delta + opt.weight_decay * p32)
        m_o = _quant(m_f) if _is_q(m) else m_f
        v_o = _quant(v_f) if _is_q(v) else v_f
        return new_p.to(p.dtype), m_o, v_o

    flat_p = _tree.leaves(params)
    flat_g = _tree.leaves(grads)
    flat_m = _tree.leaves(state.m, is_leaf=_is_q)
    flat_v = _tree.leaves(state.v, is_leaf=_is_q)
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError("params, grads and moments differ in structure")
    out = [upd(p, g, m, v) for p, g, m, v in
           zip(flat_p, flat_g, flat_m, flat_v)]
    new_p = _tree.unflatten(params, [o[0] for o in out])
    new_m = _tree.unflatten(state.m, [o[1] for o in out], is_leaf=_is_q)
    new_v = _tree.unflatten(state.v, [o[2] for o in out], is_leaf=_is_q)
    return new_p, AdamWState(step=step, m=new_m, v=new_v)
