"""Public conv op: uniform 1D/2D/3D strided convolution on the hand kernel.

Handles what surrounds the kernel: rank lifting to the canonical 3D layout
(2D lifts as [N, H, 1, W, C]), the ``(lo, hi)`` input pad (the kernel's
masked loads read zeros there, so nothing is padded on the host), the
fused epilogue and the output-dtype rule.  The kernel reads taps in
kernel-element order, so the weights go in as a reshape of
``[*K, Cin/G, Cout]``, no gather.  Every call runs against a
``repro_torch.core.engine.UniformEngine`` whose geometry-keyed plan cache
picks the kernel's channel tile once per layer geometry.
"""

from __future__ import annotations

import torch

from repro_torch.core.functional import _canon, canon_padding, \
    conv_output_shape
from repro_torch.kernels import common as _common
from repro_torch.kernels.conv import kernel as _k


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
    out3 = conv_output_shape(x3.shape[1:4], kernel3, stride3, pads3, dil3)
    if any(o < 1 for o in out3):
        raise ValueError(f"conv of {tuple(x.shape)} with kernel {kernel3} "
                         f"and padding {pads3} has empty output {out3}")
    plan = engine.plan("conv", x3.shape[1:4], kernel3, stride3,
                       x3.shape[-1], co, groups=groups, dilation=dil3,
                       in_dtype_bytes=x3.element_size(),
                       w_dtype_bytes=w3.element_size())
    w_flat = w3.reshape(-1, *w3.shape[3:]).contiguous()
    kwargs = dict(kernel=kernel3, stride=stride3, dilation=dil3,
                  groups=groups, pad_lo=tuple(lo for lo, _ in pads3),
                  out_spatial=out3, scale=_common.scale_vector(w_scale, co),
                  bias=bias, activation=activation, alpha=float(alpha),
                  out_dtype=engine.config.preferred_element_type,
                  block_co=plan.block_co)
    shape = _common.unlift_shape(x.shape[0], out3, co, squeeze)
    return x3, w_flat, kwargs, shape


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
    else x's.
    """
    x3, w_flat, kwargs, shape = conv_kernel_args(
        x, w, stride, padding, dilation=dilation, groups=groups, bias=bias,
        w_scale=w_scale, activation=activation, alpha=alpha, engine=engine)
    return _k.conv_fwd(x3, w_flat, **kwargs).reshape(shape)
