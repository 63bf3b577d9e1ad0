"""Public deconv op: uniform 1D/2D/3D IOM deconvolution on the hand kernel.

Handles what surrounds the kernel: rank lifting to the canonical 3D layout
(2D lifts as [N, H, 1, W, C]), the phase-major weight gather (each phase's
taps become one contiguous [taps * Cin/G, Cout] matrix; int8 weights
beside int8 activations K-major instead, ``common.kmajor_weights``), the
per-dim ``(lo, hi)`` crop (folded into the kernel's store), the fused
epilogue and the output-dtype rule.  Channels need no padding: the kernel
masks ragged channel tiles inside each group.  Every call runs against a
``repro_torch.core.engine.UniformEngine`` whose geometry-keyed plan cache
picks the kernel's channel tile once per layer geometry.

When a gradient is wanted the op runs as ``_DeconvFn``, a
``torch.autograd.Function`` whose backward is on the hand kernels too: dx
is the conv kernel with the channel roles swapped (``kernel.deconv_dx``),
dw the dw kernel (``kernel.deconv_dw``).  Under ``torch.no_grad`` /
``inference_mode``, or when no input wants a gradient, the forward runs
directly.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.functional import (
    _canon,
    canon_padding,
    deconv_output_shape,
)
from repro_torch.kernels import common as _common
from repro_torch.kernels.deconv import kernel as _k


def deconv_kernel_args(x, w, stride, padding=0, *, dilation=1,
                       groups: int = 1, bias=None, w_scale=None,
                       activation: str = "none", alpha: float = 0.2,
                       engine=None):
    """Everything ``deconv`` hands the kernel wrapper: returns
    ``(x3, w_taps, kwargs, out_shape)`` so that
    ``kernel.deconv_fwd(x3, w_taps, **kwargs).reshape(out_shape)`` is the
    op's result.  ``chip_smoke.py`` uses it to feed the kernel and its
    plain version the exact main-path inputs."""
    if engine is None:
        from repro_torch.core.engine import default_engine
        engine = default_engine(method="pallas")
    if activation not in _common.ACTIVATIONS:
        raise ValueError(f"activation must be one of {_common.ACTIVATIONS}, "
                         f"got {activation!r}")
    if x.shape[-1] % groups or w.shape[-1] % groups:
        raise ValueError(f"groups={groups} must divide Cin={x.shape[-1]} "
                         f"and Cout={w.shape[-1]}")
    rank = x.dim() - 2
    pads3 = _common.lift_padding(canon_padding(padding, rank), rank)
    dil3 = _common.lift_tuple3(_common.canon_dilation(dilation, rank), rank)
    x3, w3, stride3, squeeze = _common.lift_3d(x.contiguous(), w,
                                               _canon(stride, rank))
    kernel3 = tuple(w3.shape[:3])
    co = w3.shape[-1]
    plan = engine.plan("deconv", x3.shape[1:4], kernel3, stride3,
                       x3.shape[-1], co, groups=groups, dilation=dil3,
                       in_dtype_bytes=x3.element_size(),
                       w_dtype_bytes=w3.element_size())
    full3 = deconv_output_shape(x3.shape[1:4], kernel3, stride3, 0, dil3)
    # a crop that leaves nothing is empty (the wrapper launches nothing)
    out3 = tuple(max(f - lo - hi, 0) for f, (lo, hi) in zip(full3, pads3))
    # the int8 x int8 route reads its weights K-major; the others the
    # phase-major slabs
    if x3.dtype == w3.dtype == torch.int8:
        w_taps = _common.relayout(engine, "deconv", kernel3, stride3,
                                  _common.kmajor_weights, w3, kernel3,
                                  stride3, dil3, groups)
    else:
        w_taps = _common.relayout(engine, "deconv", kernel3, stride3,
                                  _common.phase_major_weights, w3, kernel3,
                                  stride3, dil3)
    kwargs = dict(kernel=kernel3, stride=stride3, dilation=dil3,
                  groups=groups, crop_lo=tuple(lo for lo, _ in pads3),
                  out_spatial=out3, scale=_common.scale_vector(w_scale, co),
                  bias=bias, activation=activation, alpha=float(alpha),
                  out_dtype=engine.config.preferred_element_type,
                  block_co=plan.block_co, split=plan.split)
    shape = _common.unlift_shape(x.shape[0], out3, co, squeeze)
    return x3, w_taps, kwargs, shape


def _forward(x, w, b, w_scale, stride, padding, dilation, groups,
             activation, alpha, engine):
    x3, w_taps, kwargs, shape = deconv_kernel_args(
        x, w, stride, padding, dilation=dilation, groups=groups, bias=b,
        w_scale=w_scale, activation=activation, alpha=alpha, engine=engine)
    return _k.deconv_fwd(x3, w_taps, **kwargs).reshape(shape)


class _DeconvFn(torch.autograd.Function):
    """The deconv with its backward on the hand kernels (JAX
    ``deconv/ops.py``'s custom VJP)."""

    @staticmethod
    def forward(ctx, x, w, b, w_scale, *args):
        return _common.op_forward(ctx, _forward, x, w, b, w_scale, *args)

    @staticmethod
    def backward(ctx, dy):
        return _common.op_backward(ctx, "deconv", dy,
                                   deconv_backward_args, _k.deconv_dx,
                                   _k.deconv_dw)


def deconv_backward_args(x, w, dy, stride, padding=0, *, dilation=1,
                         groups: int = 1, engine=None, dx: bool = True,
                         dw: bool = True):
    """Everything the deconv's backward hands its two kernel wrappers:
    ``(dx_args, dw_args)``, each ``(a, b, kwargs)``, so that
    ``kernel.deconv_dx(a, b, **kwargs)`` of dx_args is dx (in x's lifted
    shape) and ``kernel.deconv_dw(a, b, **kwargs)`` of dw_args is dw
    ([prod(K), Cin/G, Cout], taps in kernel-element order); either is
    None when ``dx``/``dw`` does not ask for it.  ``dy`` is the cotangent
    of the pre-activation output, ``w`` the (dequantized) weights.
    ``chip_smoke.py`` feeds the kernels and their plain versions the
    exact main-path inputs through it."""
    rank = x.dim() - 2
    pads3 = _common.lift_padding(canon_padding(padding, rank), rank)
    dil3 = _common.lift_tuple3(_common.canon_dilation(dilation, rank), rank)
    x3, w3, stride3, _ = _common.lift_3d(x.contiguous(), w,
                                         _canon(stride, rank))
    dy3 = _common.lift_activation(dy.contiguous())
    kernel3 = tuple(w3.shape[:3])
    ci, co = x3.shape[-1], w3.shape[-1]
    crop_lo = tuple(lo for lo, _ in pads3)
    plan = engine.plan("deconv", x3.shape[1:4], kernel3, stride3, ci, co,
                       groups=groups, dilation=dil3,
                       in_dtype_bytes=x3.element_size(), backward=True,
                       rows=x3.shape[0] * math.prod(x3.shape[1:4]))
    geometry = dict(kernel=kernel3, stride=stride3, dilation=dil3,
                    groups=groups)
    dx_args = dw_args = None
    if dx:
        # the conv kernel contracting Co within each group, the crop's lo
        # its pad, over x's extent
        w_dx = _common.relayout(engine, "deconv", kernel3, stride3,
                                _common.regroup_for_dx,
                                w3.reshape(-1, ci // groups, co),
                                groups).to(dy3.dtype)
        dx_args = (dy3, w_dx, dict(geometry, pad_lo=crop_lo,
                                    out_spatial=tuple(x3.shape[1:4]),
                                    out_dtype=x.dtype,
                                    block_co=plan.dx.block_co))
    if dw:
        dw_args = (x3, dy3.to(x3.dtype), dict(geometry, lo=crop_lo,
                                               out_dtype=w.dtype,
                                               block_a=plan.dw.block_a,
                                               block_c=plan.dw.block_c,
                                               splits=plan.dw.splits))
    return dx_args, dw_args


def deconv(x: torch.Tensor, w: torch.Tensor, stride, padding=0, *,
           dilation=1, groups: int = 1, bias: torch.Tensor | None = None,
           w_scale: torch.Tensor | None = None, activation: str = "none",
           alpha: float = 0.2, engine=None) -> torch.Tensor:
    """Uniform 1D/2D/3D IOM deconvolution through the hand kernel.

    x: [N, *spatial, Cin]; w: [*K, Cin/groups, Cout]; returns channels-last
    output of extent (I-1)*S + (K-1)*dilation + 1 - lo - hi per dim.
    ``padding`` is a scalar, per-dim scalars, or per-dim ``(lo, hi)`` crop
    pairs; ``groups`` blocks channels lax-style; ``w_scale`` (per-cout or
    scalar), ``bias`` and ``activation`` fuse into the kernel's epilogue,
    scale -> bias -> activation on the f32 sum.  The output dtype is the
    engine's ``preferred_element_type``, else x's.  Differentiable in x,
    w, bias and w_scale.
    """
    if engine is None:
        from repro_torch.core.engine import default_engine
        engine = default_engine(method="pallas")
    args = (x, w, bias, w_scale, stride, padding, dilation, groups,
            activation, float(alpha), engine)
    if _common.wants_grad(x, w, bias, w_scale):
        return _DeconvFn.apply(*args)
    return _forward(*args)
