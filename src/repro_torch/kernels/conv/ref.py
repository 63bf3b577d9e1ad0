"""Plain PyTorch version of the conv kernel (``kernel.conv_fwd``).

The same function as the CUDA kernel, stated independently of its tiling:
the input is zero-padded explicitly, then for every tap one f32 ``einsum``
of the strided input window against the tap's weights accumulates into the
output; the epilogue and the cast follow.  It does not call ``F.conv3d``.
The CPU path of the wrapper runs it, and ``chip_smoke.py`` holds the kernel
against it on the card.

``conv_reference`` is the op's reference lowering (the ``xla`` method,
``functional.correlate``) and ``conv_loop_oracle`` the reference's
float64 Python-loop oracle of the correlation, for tiny shapes.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from repro_torch.core.functional import (  # noqa: F401 (re-export)
    _canon,
    canon_padding,
    conv_output_shape,
    correlate,
)

from repro_torch.kernels import common as _common
from repro_torch.kernels.build import default_out_dtype


def conv_fwd_plain(x, w, *, kernel, stride, dilation, groups, pad_lo,
                   out_spatial, scale=None, bias=None, activation="none",
                   alpha=0.2, out_dtype=None):
    """x [N, D, H, W, Ci], w [prod(K), Ci/G, Co] in kernel-element order
    (or the int8 route's K-major ``[1, G, Co/G, kp]``) -> y [N,
    *out_spatial, Co]: ``y[o] = sum_k x[o*S + k*dil - lo] w[k]``, of dtype
    ``out_dtype`` (default x's, f32 for int8 x).  Sums in f32 (int8
    operands cast to f32 first), or in float64 for float64 inputs."""
    n, ci = x.shape[0], x.shape[-1]
    if w.dim() == 4:
        w = _common.taps_from_kmajor(w, kernel, (1, 1, 1), dilation,
                                     ci // groups)
    co = w.shape[-1]
    cig, cog = ci // groups, co // groups
    # the padded window every output reads: [-lo, (O-1)*S + (K-1)*dil - lo]
    need = tuple((o - 1) * s + (k - 1) * dl + 1 for o, s, k, dl in
                 zip(out_spatial, stride, kernel, dilation))
    acc_dtype = torch.promote_types(x.dtype, torch.float32)
    xp = x.new_zeros((n, *need, ci), dtype=acc_dtype)
    keep = tuple(max(0, min(i, nd - lo))
                 for i, nd, lo in zip(x.shape[1:4], need, pad_lo))
    xp[:, pad_lo[0]:pad_lo[0] + keep[0], pad_lo[1]:pad_lo[1] + keep[1],
       pad_lo[2]:pad_lo[2] + keep[2]] = \
        x[:, :keep[0], :keep[1], :keep[2]].to(acc_dtype)
    xp = xp.reshape(n, *need, groups, cig)
    y = x.new_zeros((n, *out_spatial, groups, cog), dtype=acc_dtype)
    for t, k in enumerate(itertools.product(*(range(kk) for kk in kernel))):
        win = xp[:, k[0] * dilation[0]:k[0] * dilation[0] + need[0]
                 - (kernel[0] - 1) * dilation[0]:stride[0],
                 k[1] * dilation[1]:k[1] * dilation[1] + need[1]
                 - (kernel[1] - 1) * dilation[1]:stride[1],
                 k[2] * dilation[2]:k[2] * dilation[2] + need[2]
                 - (kernel[2] - 1) * dilation[2]:stride[2]]
        wk = w[t].to(acc_dtype).reshape(cig, groups, cog)
        y += torch.einsum("ndhwgc,cgo->ndhwgo", win, wk)
    y = _common.apply_epilogue(y.reshape(n, *out_spatial, co), bias,
                               activation, alpha, scale)
    return y.to(out_dtype or default_out_dtype(x)).contiguous()


def conv_reference(x, w, stride=1, padding=0, *,
                   preferred_element_type=torch.float32):
    """The op's reference lowering (channels-last, rank-generic,
    correlation): ``functional.correlate``, in
    ``preferred_element_type``."""
    return correlate(x, w, stride, padding).to(preferred_element_type)


def conv_loop_oracle(x, w, stride=1, padding=0) -> torch.Tensor:
    """``y[n, o] += xpad[n, o*S + k] @ w[k]`` in float64 Python loops (the
    JAX package's oracle) -- tiny shapes only."""
    x = np.asarray(x, np.float64)
    w = np.asarray(w, np.float64)
    rank = x.ndim - 2
    stride = _canon(stride, rank)
    pads = canon_padding(padding, rank)
    kernel = w.shape[:rank]
    in_sp = x.shape[1:-1]
    out_sp = conv_output_shape(in_sp, kernel, stride, pads)
    xp = np.pad(x, [(0, 0)] + list(pads) + [(0, 0)])
    y = np.zeros((x.shape[0], *out_sp, w.shape[-1]))
    for n in range(x.shape[0]):
        for o in itertools.product(*(range(v) for v in out_sp)):
            for k in itertools.product(*(range(v) for v in kernel)):
                i = tuple(oo * s + kk for oo, s, kk in zip(o, stride, k))
                y[(n,) + o] += xp[(n,) + i] @ w[k]
    return torch.from_numpy(y)
