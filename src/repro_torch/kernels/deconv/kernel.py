"""Wrapper of the hand-written Hopper deconv kernel (``csrc/deconv_fwd.cu``).

It replaces the JAX package's TPU kernel ``deconv_pallas_3d``.  The kernel
gathers: each CUDA block owns one output phase, a tile of phase positions
and a block of output channels, and sums every tap of its phase in f32
registers; see the note at the top of the source.  ``launches`` counts the
kernel launches made through this wrapper, and nothing else.

On a CPU tensor the wrapper runs the plain version (``ref.py``); on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.functional import deconv_output_shape
from repro_torch.core.tiling import KERNEL_TILES
from repro_torch.kernels import build as _build
from repro_torch.kernels import common as _common
from repro_torch.kernels.deconv import ref as _ref

launches = 0


def deconv_fwd(x: torch.Tensor, w_taps: torch.Tensor, *, kernel, stride,
               dilation=(1, 1, 1), groups: int = 1, crop_lo=(0, 0, 0),
               out_spatial=None, scale: torch.Tensor | None = None,
               bias: torch.Tensor | None = None, activation: str = "none",
               alpha: float = 0.2, out_dtype: torch.dtype | None = None,
               block_co: int = 64) -> torch.Tensor:
    """Polyphase IOM deconv on the canonical rank-3 layout.

    x: [N, D, H, W, Ci]; w_taps: [prod(K), Ci/G, Co] in the phase-major
    order of ``common.phase_major_tap_index``.  The output is the Eq. (1)
    extent with ``crop_lo`` rows removed in front of each dim, cut to
    ``out_spatial`` (default: the rest of the extent), then
    ``act(acc * scale + bias)`` cast to ``out_dtype`` (default x's).
    ``block_co`` picks the kernel's output-channel tile (the planner's).
    """
    global launches
    kernel, stride = tuple(kernel), tuple(stride)
    dilation, crop_lo = tuple(dilation), tuple(crop_lo)
    if x.dim() != 5 or w_taps.dim() != 3:
        raise ValueError(f"expected x [N,D,H,W,Ci] and w_taps [taps,Ci/G,Co],"
                         f" got {tuple(x.shape)} and {tuple(w_taps.shape)}")
    n, d, h, wd, ci = x.shape
    co = w_taps.shape[-1]
    if (ci % groups or co % groups or w_taps.shape[1] != ci // groups
            or w_taps.shape[0] != math.prod(kernel)):
        raise ValueError(f"w_taps {tuple(w_taps.shape)} does not fit "
                         f"Ci={ci}, groups={groups}, kernel={kernel}")
    if activation not in _common.ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    full = deconv_output_shape((d, h, wd), kernel, stride, 0, dilation)
    if out_spatial is None:
        out_spatial = tuple(f - lo for f, lo in zip(full, crop_lo))
    out_spatial = tuple(out_spatial)
    if any(lo < 0 or o < 1 or lo + o > f
           for lo, o, f in zip(crop_lo, out_spatial, full)):
        raise ValueError(f"crop {crop_lo} / extent {out_spatial} does not "
                         f"fit the Eq. (1) extent {full}")
    out_dtype = out_dtype or x.dtype
    scale32, bias32 = _build.check_operands(x, w_taps, scale, bias,
                                            out_dtype, co=co)
    if x.device.type == "cpu":
        return _ref.deconv_fwd_plain(
            x, w_taps, kernel=kernel, stride=stride, dilation=dilation,
            groups=groups, crop_lo=crop_lo, out_spatial=out_spatial,
            scale=scale, bias=bias, activation=activation, alpha=alpha,
            out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no deconv kernel for device {x.device}")
    if block_co not in KERNEL_TILES:
        raise ValueError(f"block_co {block_co} not in {sorted(KERNEL_TILES)}")
    lib = _build.library()
    q = tuple(i + m - 1 for i, m in
              zip((d, h, wd), _common.phase_geometry(kernel, stride,
                                                     dilation)))
    taps = _common.tap_table(kernel, stride, dilation, x.device)
    y = torch.empty((n, *out_spatial, co), dtype=out_dtype, device=x.device)
    geom = _build.geom_array((n, d, h, wd, ci, co, groups, *kernel, *stride,
                              *dilation, *q, *out_spatial, *crop_lo))
    err = lib.repro_deconv_fwd(
        _build.ptr(x), _build.ptr(w_taps), _build.ptr(taps),
        _build.ptr(scale32), _build.ptr(bias32), _build.ptr(y), geom,
        _common.ACTIVATION_CODES[activation], float(alpha),
        _build.DTYPE_CODES[x.dtype], _build.DTYPE_CODES[out_dtype],
        block_co, _build.stream_of(x))
    if err:
        raise RuntimeError(f"deconv kernel launch failed (cudaError {err})")
    launches += 1
    return y
