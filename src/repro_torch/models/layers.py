"""Shared model layers (JAX ``models/layers.py``): initialisers, norms,
activations, rotary embeddings (M-RoPE included) and the embedding lookup.

Weights are drawn in f32 from an explicit ``torch.Generator`` on the
generator's device, then cast to ``dtype`` and moved to ``device``; the
JAX package's logical sharding axes have no counterpart on one card.
``device="meta"`` gives shapes without drawing.
The norms and the rotation compute in f32 and cast back, as the
reference's do.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def dense_init(generator: torch.Generator, shape: Sequence[int],
               scale: float | None = None, dtype=torch.float32,
               device="cuda") -> torch.Tensor:
    """Normal(0, scale) weights drawn in f32 and cast to ``dtype`` (as
    the reference draws f32 and casts to the master dtype); ``scale``
    defaults to 1/sqrt(fan_in)."""
    shape = tuple(shape)
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    fan_in = shape[0] if len(shape) > 1 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    v = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device).mul_(scale)
    return v.to(device=device, dtype=dtype)


def zeros_init(shape: Sequence[int], dtype=torch.float32,
               device="cuda") -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def ones_init(shape: Sequence[int], dtype=torch.float32,
              device="cuda") -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=dtype, device=device)


def rmsnorm(x: torch.Tensor, gain: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * gain.float()).to(dt)


def layernorm(x: torch.Tensor, gain: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * gain.float() + bias.float()).to(dt)


# The activations are the reference's sequences of elementwise ops, each
# rounded to x's dtype as XLA rounds them: in bf16 torch's fused silu and
# gelu round once and differ from the reference in a third of the values.

class _Silu(torch.autograd.Function):
    """``x * (1 / (1 + exp(-x)))``, the reference's op sequence, with the
    gradient ``jax.grad`` takes through its logistic, ``s + x s (1 - s)``:
    autograd through the spelled-out sequence gives 0 * inf = NaN where
    ``exp(-x)`` overflows (x < -88.7; dbrx-132b's expert gates reach it
    at full width)."""

    @staticmethod
    def forward(ctx, x):
        s = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(x, s)
        return x * s

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        return g * s + (x * g) * (s * (1 - s))


def silu(x: torch.Tensor) -> torch.Tensor:
    return _Silu.apply(x)


def _relu2(x: torch.Tensor) -> torch.Tensor:
    return torch.square(F.relu(x))


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation (torch's to the erf),
    # its constants in x's dtype and x ** 3 as x * (x * x)
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype, device=x.device)
    k = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * (x * x))))))


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "silu":
        return silu
    if name == "gelu":
        return _gelu_tanh
    if name == "relu2":
        return _relu2
    raise ValueError(name)


# -- rotary -------------------------------------------------------------------

def _rope_freqs(half: int, theta: float, device) -> torch.Tensor:
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions [...] -> cos/sin [..., head_dim//2] (f32)."""
    half = head_dim // 2
    freqs = _rope_freqs(half, theta, positions.device)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, hd]; cos/sin [B, S, hd//2] -> rotated x."""
    dt = x.dtype
    x = x.float()
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.to(dt)


def mrope_cos_sin(positions3: torch.Tensor, head_dim: int,
                  sections: Sequence[int], theta: float):
    """Qwen2-VL M-RoPE: positions3 [3, B, S] (t, h, w streams); the rotary
    half-dim is split into ``sections`` (sum == head_dim//2), each section
    driven by its own position stream."""
    half = head_dim // 2
    assert sum(sections) == half, (sections, half)
    freqs = _rope_freqs(half, theta, positions3.device)
    cos_parts, sin_parts = [], []
    start = 0
    for sec, pos in zip(sections, positions3):
        ang = pos.float()[..., None] * freqs[start:start + sec]
        cos_parts.append(torch.cos(ang))
        sin_parts.append(torch.sin(ang))
        start += sec
    return torch.cat(cos_parts, -1), torch.cat(sin_parts, -1)


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` of the embedding table: [V, D], [B, S] -> [B, S, D].
    The backward adds a row's gradients in a fixed order (``F.embedding``
    sorts the ids), where an indexing's backward adds them with atomics
    (on the CPU too): the same gradient on every run."""
    return F.embedding(ids, table)


def remat(fn, *args):
    """``fn(*args)``, checkpointed while autograd records: nothing inside
    is saved and the backward runs ``fn`` again (the reference's
    ``jax.checkpoint`` with ``nothing_saveable``); a plain call
    otherwise."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)
