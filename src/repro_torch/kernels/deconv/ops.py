"""Public deconv op: uniform 1D/2D/3D IOM deconvolution on the hand kernel.

Handles what surrounds the kernel: rank lifting to the canonical 3D layout
(2D lifts as [N, H, 1, W, C]), the phase-major weight gather (each phase's
taps become one contiguous [taps * Cin/G, Cout] matrix), the per-dim
``(lo, hi)`` crop (folded into the kernel's store), the fused epilogue and
the output-dtype rule.  Channels need no padding: the kernel masks ragged
channel tiles inside each group.  Every call runs against a
``repro_torch.core.engine.UniformEngine`` whose geometry-keyed plan cache
picks the kernel's channel tile once per layer geometry.
"""

from __future__ import annotations

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
    out3 = tuple(f - lo - hi for f, (lo, hi) in zip(full3, pads3))
    w_taps = _common.phase_major_weights(w3, kernel3, stride3, dil3)
    kwargs = dict(kernel=kernel3, stride=stride3, dilation=dil3,
                  groups=groups, crop_lo=tuple(lo for lo, _ in pads3),
                  out_spatial=out3, scale=_common.scale_vector(w_scale, co),
                  bias=bias, activation=activation, alpha=float(alpha),
                  out_dtype=engine.config.preferred_element_type,
                  block_co=plan.block_co)
    shape = _common.unlift_shape(x.shape[0], out3, co, squeeze)
    return x3, w_taps, kwargs, shape


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
    engine's ``preferred_element_type``, else x's.
    """
    x3, w_taps, kwargs, shape = deconv_kernel_args(
        x, w, stride, padding, dilation=dilation, groups=groups, bias=bias,
        w_scale=w_scale, activation=activation, alpha=alpha, engine=engine)
    return _k.deconv_fwd(x3, w_taps, **kwargs).reshape(shape)
