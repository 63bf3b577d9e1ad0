"""Operand precisions of the reference and of its controls.

``"f32"`` leaves an operand as it is (IEEE float32, TF32 off in cuDNN
and cuBLAS: ``ieee``).  ``"tf32"`` rounds it to TF32's 10-bit mantissa,
as the tensor cores do before a TF32 product; ``"fp8"`` to float8 e4m3
with one scale for the whole tensor (its absolute maximum at 448).  The
products of a rounded operand still accumulate in float32, so a control
differs from the reference only in the precision of its operands."""

from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("f32", "tf32", "fp8")
_FP8_MAX = 448.0


def _tf32(t: torch.Tensor) -> torch.Tensor:
    bits = t.to(torch.float32).contiguous().view(torch.int32)
    # round to nearest, ties to even, on the 13 mantissa bits TF32 drops
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & -0x2000
    return bits.view(torch.float32)


def _fp8(t: torch.Tensor) -> torch.Tensor:
    t = t.to(torch.float32)
    scale = t.abs().amax().clamp(min=1e-30) / _FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _round(t: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32":
        return _tf32(t)
    if precision == "fp8":
        return _fp8(t)
    raise ValueError(f"unknown precision {precision!r}; one of {PRECISIONS}")


class _RoundForward(torch.autograd.Function):
    """Rounds an operand; its gradient passes through unchanged."""

    @staticmethod
    def forward(ctx, t, precision):
        return _round(t, precision)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _RoundBackward(torch.autograd.Function):
    """Leaves a product's result as it is; rounds the gradient that flows
    into it, which the backward products take as an operand."""

    @staticmethod
    def forward(ctx, t, precision):
        ctx.precision = precision
        return t

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.precision), None


def operand(t: torch.Tensor, precision: str) -> torch.Tensor:
    """``t`` in float32, rounded to ``precision`` first."""
    t = t.to(torch.float32)
    if precision == "f32":
        return t
    return _RoundForward.apply(t, precision)


def product(y: torch.Tensor, precision: str) -> torch.Tensor:
    """A product's result ``y``; under ``precision`` the gradient that the
    backward products take from it is rounded like a forward operand."""
    if precision == "f32":
        return y
    return _RoundBackward.apply(y, precision)


def _knobs():
    cudnn_conv = getattr(torch.backends.cudnn, "conv", None)
    if cudnn_conv is not None and hasattr(cudnn_conv, "fp32_precision"):
        return ((cudnn_conv, "fp32_precision", "ieee"),
                (torch.backends.cuda.matmul, "fp32_precision", "ieee"))
    return ((torch.backends.cudnn, "allow_tf32", False),
            (torch.backends.cuda.matmul, "allow_tf32", False))


def set_ieee() -> None:
    """IEEE float32 in cuDNN and cuBLAS for the rest of the process."""
    for mod, attr, value in _knobs():
        setattr(mod, attr, value)


@contextlib.contextmanager
def ieee():
    """IEEE float32 in cuDNN and cuBLAS inside the block."""
    knobs = _knobs()
    prev = [getattr(mod, attr) for mod, attr, _ in knobs]
    try:
        set_ieee()
        yield
    finally:
        for (mod, attr, _), value in zip(knobs, prev):
            setattr(mod, attr, value)


def named_leaves(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """The tensors of a tree of dicts, lists and tuples by dotted path, in
    the tree's own order."""
    out: dict[str, torch.Tensor] = {}
    if isinstance(tree, torch.Tensor):
        out[prefix] = tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(named_leaves(v, f"{prefix}.{k}" if prefix else str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(named_leaves(v, f"{prefix}.{i}" if prefix else str(i)))
    else:
        raise TypeError(f"unexpected leaf {type(tree)!r} at {prefix!r}")
    return out


def map_tree(fn, tree):
    """``tree`` with ``fn`` applied to each tensor."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    raise TypeError(f"unexpected leaf {type(tree)!r}")
