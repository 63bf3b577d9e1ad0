"""Plain PyTorch version of the deconv kernel (``kernel.deconv_fwd``).

The same function as the CUDA kernel, stated independently of its tiling:
for every phase and every tap of that phase, one f32 ``einsum`` of the
whole input against the tap's weights, overlap-added at the tap's offset
on the phase grid; phases interleave into the Eq. (1) output, which is then
cropped, run through the epilogue and cast.  It does not call
``F.conv_transpose3d``.  The CPU path of the wrapper runs it, and
``chip_smoke.py`` holds the kernel against it on the card.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import common as _common


def deconv_fwd_plain(x, w_taps, *, kernel, stride, dilation, groups,
                     crop_lo, out_spatial, scale=None, bias=None,
                     activation="none", alpha=0.2, out_dtype=None):
    """x [N, D, H, W, Ci], w_taps [prod(K), Ci/G, Co] phase-major ->
    y [N, *out_spatial, Co] of dtype ``out_dtype`` (default x's)."""
    n, d, h, wd, ci = x.shape
    co = w_taps.shape[-1]
    cig, cog = ci // groups, co // groups
    m_max = _common.phase_geometry(kernel, stride, dilation)
    q = tuple(i + m - 1 for i, m in zip((d, h, wd), m_max))
    xf = x.to(torch.float32).reshape(n, d, h, wd, groups, cig)
    full = x.new_zeros((n, *(qi * s for qi, s in zip(q, stride)), co),
                       dtype=torch.float32)
    off = 0
    for _, p, taps in _common.phase_taps(kernel, stride, dilation):
        acc = x.new_zeros((n, *q, co), dtype=torch.float32)
        for t, m in enumerate(taps):
            wk = w_taps[off + t].to(torch.float32).reshape(cig, groups, cog)
            contrib = torch.einsum("ndhwgc,cgo->ndhwgo", xf, wk)
            acc[:, m[0]:m[0] + d, m[1]:m[1] + h, m[2]:m[2] + wd] += \
                contrib.reshape(n, d, h, wd, co)
        off += len(taps)
        full[:, p[0]::stride[0], p[1]::stride[1], p[2]::stride[2]] = acc
    y = full[:, crop_lo[0]:crop_lo[0] + out_spatial[0],
             crop_lo[1]:crop_lo[1] + out_spatial[1],
             crop_lo[2]:crop_lo[2] + out_spatial[2]]
    y = _common.apply_epilogue(y, bias, activation, alpha, scale)
    return y.to(out_dtype or x.dtype).contiguous()
