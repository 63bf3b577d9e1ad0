"""Shared model layers (JAX ``models/layers.py``): initialisers, norms,
activations, rotary embeddings (M-RoPE included) and the embedding lookup.

Weights are drawn in f32 from an explicit ``torch.Generator`` on the
generator's device, then cast to ``dtype`` and moved to ``device``.
Each initialiser takes the leaf's logical sharding axes (the
reference's, per dim of one layer's leaf; ``None`` for a dim left
whole): ``device="meta"`` gives shapes without drawing, ``device=AXES``
the logical axes instead of a tensor, a stacked leaf's leading dims
``None``, so one initialiser draws either tree.  Inside
``drawing_blocks(mesh, fsdp)`` each leaf is drawn whole and cut at once
to this rank's block of it, so a partitioned model never holds more
than one whole leaf.

``blk_out`` is a block's out-projection, the reference's ``blk_out``
checkpoint name: under ``remat`` with ``remat_policy="save_outs"``
(``saves_outs``) its result is kept and the backward runs the block's
work before it again, but not the projection, nor the all-reduce that
follows it.
The norms and the rotation compute in f32 and cast back, as the
reference's do.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as _tree
from repro_torch.sharding.partition import local_block, logical_to_spec

# the device that makes an initialiser give its leaf's logical axes
AXES = "axes"

Logical = Sequence[str | None]


def _axes(shape, logical: Logical) -> tuple:
    """``logical`` (one layer's leaf) with ``None`` for each leading
    stacked dim of ``shape``."""
    return (None,) * (len(shape) - len(logical)) + tuple(logical)


_BLOCKS: list = []


@contextlib.contextmanager
def drawing_blocks(mesh, fsdp: bool):
    """Inside the block each initialiser returns this rank's block of
    its leaf on ``mesh`` (``logical_to_spec`` of its axes, FSDP when
    ``fsdp``), cut from the leaf drawn whole."""
    _BLOCKS.append((mesh, fsdp))
    try:
        yield
    finally:
        _BLOCKS.pop()


def _block(v: torch.Tensor, logical: Logical) -> torch.Tensor:
    if not _BLOCKS or v.device.type == "meta":
        return v
    mesh, fsdp = _BLOCKS[-1]
    spec = logical_to_spec(mesh, _axes(v.shape, logical), v.shape, fsdp)
    return local_block(v, spec, mesh).clone()


def dense_init(generator: torch.Generator, shape: Sequence[int],
               scale: float | None = None, dtype=torch.float32,
               device="cuda", logical: Logical = ()) -> torch.Tensor:
    """Normal(0, scale) weights drawn in f32 and cast to ``dtype`` (as
    the reference draws f32 and casts to the master dtype); ``scale``
    defaults to 1/sqrt(fan_in)."""
    shape = tuple(shape)
    if device == AXES:
        return _axes(shape, logical)
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    fan_in = shape[0] if len(shape) > 1 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    v = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device).mul_(scale)
    return _block(v.to(device=device, dtype=dtype), logical)


def zeros_init(shape: Sequence[int], dtype=torch.float32,
               device="cuda", logical: Logical = ()) -> torch.Tensor:
    if device == AXES:
        return _axes(shape, logical)
    return _block(torch.zeros(tuple(shape), dtype=dtype, device=device),
                  logical)


def ones_init(shape: Sequence[int], dtype=torch.float32,
              device="cuda", logical: Logical = ()) -> torch.Tensor:
    if device == AXES:
        return _axes(shape, logical)
    return _block(torch.ones(tuple(shape), dtype=dtype, device=device),
                  logical)


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


def vocab_parallel_lookup(table: torch.Tensor, ids: torch.Tensor,
                          v0: int) -> torch.Tensor:
    """This rank's part of the lookup of ``ids`` in its rows ``v0 ..
    v0 + len(table)`` of a vocab-sharded table: the rows it holds, zeros
    elsewhere (the caller sums the parts over the model axis)."""
    mine = (ids >= v0) & (ids < v0 + table.shape[0])
    h = embed_lookup(table, torch.where(mine, ids - v0, 0))
    return torch.where(mine[..., None], h, 0)


def remat(fn, *args):
    """``fn(*args)``, checkpointed while autograd records: nothing inside
    is saved and the backward runs ``fn`` again (the reference's
    ``jax.checkpoint`` with ``nothing_saveable``); a plain call
    otherwise."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


# -- remat_policy "save_outs" -----------------------------------------------

def saves_outs(cfg) -> bool:
    """True where ``cfg`` remats with the ``save_outs`` policy."""
    return bool(cfg.remat) and cfg.remat_policy == "save_outs"


def _mm_out(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``o [..., K] @ w [K, N]`` as one 2-D product."""
    return (o.reshape(-1, o.shape[-1]) @ w).reshape(*o.shape[:-1],
                                                    w.shape[-1])


class _SavedOut(torch.autograd.Function):
    """``core(*args) @ w``, saving only the inputs: the backward runs
    ``core`` again for the projection's input and takes the projection's
    gradients as autograd's 2-D product takes them (``dy w^T`` and
    ``o^T dy``), without the product itself."""

    @staticmethod
    def forward(ctx, core, skeleton, w, *flat):
        with torch.no_grad():
            o = core(*_tree.unflatten(skeleton, flat))
        ctx.core, ctx.skeleton = core, skeleton
        ctx.save_for_backward(w, *flat)
        return _mm_out(o, w)

    @staticmethod
    def backward(ctx, dy):
        w, *flat = ctx.saved_tensors
        ins = [t.detach().requires_grad_(t.requires_grad) for t in flat]
        with torch.enable_grad():
            o = ctx.core(*_tree.unflatten(ctx.skeleton, ins))
        o2, dy2 = o.reshape(-1, o.shape[-1]), dy.reshape(-1, dy.shape[-1])
        do = dy2.mm(w.t()).reshape(o.shape)
        dw = o2.detach().t().mm(dy2)
        want = [t for t in ins if t.requires_grad]
        got = iter(torch.autograd.grad(o, want, do, allow_unused=True)
                   if want else ())
        grads = [next(got) if t.requires_grad else None for t in ins]
        return (None, None, dw, *grads)


def blk_out(cfg, core, args: tuple, w: torch.Tensor) -> torch.Tensor:
    """A block's out-projection ``core(*args) @ w`` (``w`` [K, N] already
    in the activations' dtype; ``args`` trees of tensors, ``core``'s
    other inputs in its closure).  Where ``cfg`` ``saves_outs`` and
    autograd records, the result is kept and the backward runs ``core``
    again (``_SavedOut``); otherwise a plain product."""
    if not (saves_outs(cfg) and torch.is_grad_enabled()):
        return _mm_out(core(*args), w)
    flat = _tree.leaves(args)
    skeleton = _tree.unflatten(args, [0] * len(flat))
    return _SavedOut.apply(core, skeleton, w, *flat)


def blk_region(cfg, core, *args):
    """A block's work up to an output that needs no projection (the MoE
    combine): checkpointed where ``cfg`` ``saves_outs`` and autograd
    records, so its result is kept and the backward runs it again; a
    plain call otherwise."""
    if saves_outs(cfg) and torch.is_grad_enabled():
        return remat(core, *args)
    return core(*args)
