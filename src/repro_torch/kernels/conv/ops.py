"""Public conv op: uniform 1D/2D/3D strided convolution on the hand kernel.

Handles what surrounds the kernel: rank lifting to the canonical 3D layout
(2D lifts as [N, H, 1, W, C]), the ``(lo, hi)`` input pad (the kernel's
masked loads read zeros there, so nothing is padded on the host), the
fused epilogue and the output-dtype rule.  The kernel reads taps in
kernel-element order, so the weights go in as a reshape of
``[*K, Cin/G, Cout]``, no gather (int8 weights beside int8 activations
K-major, ``common.kmajor_weights``; each re-layout, forward and backward,
through ``common.relayout``).  Every call runs against a
``repro_torch.core.engine.UniformEngine`` whose geometry-keyed plan cache
picks the kernel's channel tile once per layer geometry.

When a gradient is wanted the op runs as ``_ConvFn``, whose backward
closes the adjoint loop on the hand kernels: dx is the deconv kernel on dy
with the channel roles swapped, cropped by the pad to x's extent (rows no
tap reads come out zero), and dw is the dw kernel with (x, dy) swapped.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.functional import _canon, canon_padding, \
    conv_output_shape
from repro_torch.kernels import common as _common
from repro_torch.kernels.conv import kernel as _k
from repro_torch.kernels.deconv import kernel as _dk


def conv_kernel_args(x, w, stride=1, padding=0, *, dilation=1,
                     groups: int = 1, bias=None, w_scale=None,
                     activation: str = "none", alpha: float = 0.2,
                     engine=None):
    """Everything ``conv`` hands the kernel wrapper: returns
    ``(x3, w_flat, kwargs, out_shape)`` so that
    ``kernel.conv_fwd(x3, w_flat, **kwargs).reshape(out_shape)`` is the
    op's result (``chip_smoke.py`` feeds the kernel and its plain version
    the exact main-path inputs through it)."""
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
    # an extent at or below 0 is empty (the wrapper launches nothing)
    out3 = tuple(max(o, 0) for o in conv_output_shape(
        x3.shape[1:4], kernel3, stride3, pads3, dil3))
    plan = engine.plan("conv", _common.padded_extent(x3.shape[1:4], pads3),
                       kernel3, stride3, x3.shape[-1], co, groups=groups,
                       dilation=dil3, in_dtype_bytes=x3.element_size(),
                       w_dtype_bytes=w3.element_size())
    # the int8 x int8 route reads its weights K-major (one phase)
    if x3.dtype == w3.dtype == torch.int8:
        w_flat = _common.relayout(engine, "conv", kernel3, stride3,
                                  _common.kmajor_weights, w3, kernel3,
                                  (1, 1, 1), dil3, groups)
    else:
        w_flat = w3.reshape(-1, *w3.shape[3:]).contiguous()
    kwargs = dict(kernel=kernel3, stride=stride3, dilation=dil3,
                  groups=groups, pad_lo=tuple(lo for lo, _ in pads3),
                  out_spatial=out3, scale=_common.scale_vector(w_scale, co),
                  bias=bias, activation=activation, alpha=float(alpha),
                  out_dtype=engine.config.preferred_element_type,
                  block_co=plan.block_co, split=plan.split)
    shape = _common.unlift_shape(x.shape[0], out3, co, squeeze)
    return x3, w_flat, kwargs, shape


def _forward(x, w, b, w_scale, stride, padding, dilation, groups,
             activation, alpha, engine):
    x3, w_flat, kwargs, shape = conv_kernel_args(
        x, w, stride, padding, dilation=dilation, groups=groups, bias=b,
        w_scale=w_scale, activation=activation, alpha=alpha, engine=engine)
    return _k.conv_fwd(x3, w_flat, **kwargs).reshape(shape)


class _ConvFn(torch.autograd.Function):
    """The conv with its backward on the hand kernels (JAX
    ``conv/ops.py``'s custom VJP)."""

    @staticmethod
    def forward(ctx, x, w, b, w_scale, *args):
        return _common.op_forward(ctx, _forward, x, w, b, w_scale, *args)

    @staticmethod
    def backward(ctx, dy):
        return _common.op_backward(ctx, "conv", dy, conv_backward_args,
                                   _dk.deconv_fwd, _dk.deconv_dw)


def conv_backward_args(x, w, dy, stride=1, padding=0, *, dilation=1,
                       groups: int = 1, engine=None, dx: bool = True,
                       dw: bool = True):
    """Everything the conv's backward hands its two kernel wrappers:
    ``(dx_args, dw_args)``, each ``(a, b, kwargs)``, so that
    ``deconv.kernel.deconv_fwd(a, b, **kwargs)`` of dx_args is dx (in x's
    lifted shape) and ``deconv.kernel.deconv_dw(a, b, **kwargs)`` of
    dw_args is dw ([prod(K), Cin/G, Cout]); either is None when
    ``dx``/``dw`` does not ask for it.  ``dy`` is the cotangent of the
    pre-activation output, ``w`` the (dequantized) weights.
    ``chip_smoke.py`` feeds the kernels and their plain versions the exact
    main-path inputs through it."""
    rank = x.dim() - 2
    pads3 = _common.lift_padding(canon_padding(padding, rank), rank)
    dil3 = _common.lift_tuple3(_common.canon_dilation(dilation, rank), rank)
    x3, w3, stride3, _ = _common.lift_3d(x.contiguous(), w,
                                         _canon(stride, rank))
    dy3 = _common.lift_activation(dy.contiguous())
    kernel3 = tuple(w3.shape[:3])
    ci, co = x3.shape[-1], w3.shape[-1]
    pad_lo = tuple(lo for lo, _ in pads3)
    plan = engine.plan("conv", _common.padded_extent(x3.shape[1:4], pads3),
                       kernel3, stride3, ci, co, groups=groups,
                       dilation=dil3, in_dtype_bytes=x3.element_size(),
                       backward=True,
                       rows=dy3.shape[0] * math.prod(dy3.shape[1:4]))
    geometry = dict(kernel=kernel3, stride=stride3, dilation=dil3,
                    groups=groups)
    dx_args = dw_args = None
    if dx:
        # the deconv kernel on dy, contracting Co within each group and
        # producing all of Ci (weights phase-major, as that kernel reads
        # them), cropped by the pad to x's extent: rows no tap reads get
        # zero
        w_dx = _common.relayout(engine, "conv", kernel3, stride3,
                                _common.regroup_for_dx,
                                w3.reshape(-1, ci // groups, co), groups)
        w_dx = _common.relayout(engine, "conv", kernel3, stride3,
                                _common.phase_major_weights,
                                w_dx.reshape(*kernel3, co // groups, ci),
                                kernel3, stride3, dil3).to(dy3.dtype)
        dx_args = (dy3, w_dx, dict(geometry, crop_lo=pad_lo,
                                    out_spatial=tuple(x3.shape[1:4]),
                                    out_dtype=x.dtype,
                                    block_co=plan.dx.block_co))
    if dw:
        # (x, dy) swapped, dy the unstrided operand; the transposed store
        # lands the weights' [taps, Ci/G, Co] layout
        dw_args = (dy3.to(x3.dtype), x3, dict(geometry, lo=pad_lo,
                                               transpose=True,
                                               out_dtype=w.dtype,
                                               block_a=plan.dw.block_a,
                                               block_c=plan.dw.block_c,
                                               splits=plan.dw.splits))
    return dx_args, dw_args


def conv(x: torch.Tensor, w: torch.Tensor, stride=1, padding=0, *,
         dilation=1, groups: int = 1, bias: torch.Tensor | None = None,
         w_scale: torch.Tensor | None = None, activation: str = "none",
         alpha: float = 0.2, engine=None) -> torch.Tensor:
    """Uniform 1D/2D/3D strided convolution through the hand kernel.

    x: [N, *spatial, Cin]; w: [*K, Cin/groups, Cout]; semantics match
    ``lax.conv_general_dilated`` (correlation, channels-last,
    ``rhs_dilation=dilation``, ``feature_group_count=groups``): per-dim
    output extent ``(I + lo + hi - (K-1)*dilation - 1) // S + 1``.
    ``w_scale``, ``bias`` and ``activation`` fuse into the kernel's
    epilogue; the output dtype is the engine's ``preferred_element_type``,
    else x's.  Differentiable in x, w, bias and w_scale.
    """
    if engine is None:
        from repro_torch.core.engine import default_engine
        engine = default_engine(method="pallas")
    args = (x, w, bias, w_scale, stride, padding, dilation, groups,
            activation, float(alpha), engine)
    if _common.wants_grad(x, w, bias, w_scale):
        return _ConvFn.apply(*args)
    return _forward(*args)
