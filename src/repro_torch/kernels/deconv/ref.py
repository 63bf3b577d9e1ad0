"""Plain PyTorch version of the deconv kernel (``kernel.deconv_fwd``).

The same function as the CUDA kernel, stated independently of its tiling:
for every phase and every tap of that phase, one f32 ``einsum`` of the
whole input against the tap's weights, overlap-added at the tap's offset
on the phase grid; phases interleave into the Eq. (1) output, which is then
cropped, run through the epilogue and cast.  It does not call
``F.conv_transpose3d``.  The CPU path of the wrapper runs it, and
``chip_smoke.py`` holds the kernel against it on the card.

``deconv_dw_plain`` is the plain version of the dw kernel
(``kernel.deconv_dw``): one ``einsum`` per tap of the unstrided operand
against a strided window of the zero-padded other one.

``deconv_reference`` is the op's reference lowering (the ``xla`` method,
``functional.deconv_xla``) and ``deconv_loop_oracle`` the reference's
float64 Python-loop oracle of the canonical definition, for tiny shapes.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from repro_torch.core.functional import (
    canon_padding,
    deconv_output_shape,
    deconv_xla,
)

from repro_torch.kernels import common as _common
from repro_torch.kernels.build import default_out_dtype


def phase_rows(in_spatial, kernel, stride, dilation, crop_lo, out_spatial):
    """Phase positions per dim that the deconv kernel runs over: the
    Eq. (1) grid ``I + M - 1``, widened when the cropped extent reaches
    past it (a conv's dx on input rows no tap reads: those rows are
    zero)."""
    m_max = _common.phase_geometry(kernel, stride, dilation)
    return tuple(max(i + m - 1, -(-(lo + o) // s))
                 for i, m, s, lo, o in zip(in_spatial, m_max, stride, crop_lo,
                                           out_spatial))


def deconv_fwd_plain(x, w_taps, *, kernel, stride, dilation, groups,
                     crop_lo, out_spatial, scale=None, bias=None,
                     activation="none", alpha=0.2, out_dtype=None):
    """x [N, D, H, W, Ci], w_taps [prod(K), Ci/G, Co] phase-major (or the
    int8 route's K-major ``[prod(S), G, Co/G, kp]``) -> y [N,
    *out_spatial, Co] of dtype ``out_dtype`` (default x's, f32 for int8
    x).  Sums in f32 (int8 operands cast to f32 first), or in float64 for
    float64 inputs (the yardstick on the card)."""
    n, d, h, wd, ci = x.shape
    if w_taps.dim() == 4:
        w_taps = _common.taps_from_kmajor(w_taps, kernel, stride, dilation,
                                          ci // groups)
    co = w_taps.shape[-1]
    cig, cog = ci // groups, co // groups
    q = phase_rows((d, h, wd), kernel, stride, dilation, crop_lo,
                   out_spatial)
    acc_dtype = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc_dtype).reshape(n, d, h, wd, groups, cig)
    full = x.new_zeros((n, *(qi * s for qi, s in zip(q, stride)), co),
                       dtype=acc_dtype)
    off = 0
    for _, p, taps in _common.phase_taps(kernel, stride, dilation):
        acc = x.new_zeros((n, *q, co), dtype=acc_dtype)
        for t, m in enumerate(taps):
            wk = w_taps[off + t].to(acc_dtype).reshape(cig, groups, cog)
            contrib = torch.einsum("ndhwgc,cgo->ndhwgo", xf, wk)
            acc[:, m[0]:m[0] + d, m[1]:m[1] + h, m[2]:m[2] + wd] += \
                contrib.reshape(n, d, h, wd, co)
        off += len(taps)
        full[:, p[0]::stride[0], p[1]::stride[1], p[2]::stride[2]] = acc
    y = full[:, crop_lo[0]:crop_lo[0] + out_spatial[0],
             crop_lo[1]:crop_lo[1] + out_spatial[1],
             crop_lo[2]:crop_lo[2] + out_spatial[2]]
    y = _common.apply_epilogue(y, bias, activation, alpha, scale)
    return y.to(out_dtype or default_out_dtype(x)).contiguous()


def deconv_dw_plain(a, b, *, kernel, stride, dilation, groups, lo,
                    transpose=False, out_dtype=None):
    """``out[t, i, g*Bg + j] = sum_p a[p, g*Ag + i] * b[p*S + k_t*dil - lo,
    g*Bg + j]`` over every position p of ``a`` (batch included), reads of
    ``b`` outside its extent zero, taps t in kernel-element order.

    a: [N, *A spatial, Ac]; b: [N, *B spatial, Bc]; returns
    [prod(K), Ac/G, Bc], or [prod(K), Bc/G, Ac] stored
    ``[t, j, g*Ag + i]`` when ``transpose`` (the conv's dw).  Sums in f32,
    or in float64 for float64 inputs (the yardstick on the card).
    """
    acc_dtype = torch.promote_types(a.dtype, torch.float32)
    n, asp, ac = a.shape[0], tuple(a.shape[1:4]), a.shape[-1]
    bc = b.shape[-1]
    ag, bg = ac // groups, bc // groups
    # the zero-padded window every tap reads: [-lo, (A-1)*S + (K-1)*dil - lo]
    need = tuple((i - 1) * s + (k - 1) * dl + 1 for i, s, k, dl in
                 zip(asp, stride, kernel, dilation))
    bp = b.new_zeros((n, *need, bc), dtype=acc_dtype)
    src = tuple(slice(max(0, -l), min(e, nd - l))
                for l, e, nd in zip(lo, b.shape[1:4], need))
    dst = tuple(slice(s.start + l, s.stop + l) for s, l in zip(src, lo))
    if all(s.stop > s.start for s in src):
        bp[(slice(None), *dst)] = b[(slice(None), *src)].to(acc_dtype)
    af = a.to(acc_dtype).reshape(n, *asp, groups, ag)
    bp = bp.reshape(n, *need, groups, bg)
    outs = []
    for k in itertools.product(*(range(kk) for kk in kernel)):
        win = bp[(slice(None),) + tuple(
            slice(kj * dl, kj * dl + (i - 1) * s + 1, s)
            for kj, dl, i, s in zip(k, dilation, asp, stride))]
        outs.append(torch.einsum("ndhwgi,ndhwgj->gij", af, win))
    res = torch.stack(outs)                          # [taps, G, Ag, Bg]
    if transpose:
        res = res.permute(0, 3, 1, 2).reshape(len(outs), bg, ac)
    else:
        res = res.permute(0, 2, 1, 3).reshape(len(outs), ag, bc)
    return res.to(out_dtype or a.dtype).contiguous()


def deconv_reference(x, w, stride, padding=0):
    """The op's reference lowering (channels-last, rank-generic, f32
    out): ``functional.deconv_xla``."""
    return deconv_xla(x, w, stride, padding)


def deconv_loop_oracle(x, w, stride, padding=0) -> torch.Tensor:
    """``y[n, i*S + k] += x[n, i] @ w[k]`` in float64 Python loops, then
    the ``padding`` crop (the JAX package's oracle) -- tiny shapes only."""
    x = np.asarray(x, np.float64)
    w = np.asarray(w, np.float64)
    rank = x.ndim - 2
    stride = (stride,) * rank if isinstance(stride, int) else tuple(stride)
    pads = canon_padding(padding, rank)
    kernel = w.shape[:rank]
    in_sp = x.shape[1:-1]
    out_sp = deconv_output_shape(in_sp, kernel, stride, 0)
    y = np.zeros((x.shape[0], *out_sp, w.shape[-1]))
    for n in range(x.shape[0]):
        for i in itertools.product(*(range(v) for v in in_sp)):
            for k in itertools.product(*(range(v) for v in kernel)):
                o = tuple(ii * s + kk for ii, s, kk in zip(i, stride, k))
                y[(n,) + o] += x[(n,) + i] @ w[k]
    idx = (slice(None),) + tuple(slice(lo, d - hi)
                                 for (lo, hi), d in zip(pads, out_sp)) \
        + (slice(None),)
    return torch.from_numpy(np.ascontiguousarray(y[idx]))
