"""Wrapper of the hand-written Hopper conv kernel (``csrc/conv_fwd.cu``).

It replaces the JAX package's TPU kernel ``conv_pallas_3d``.  Each CUDA
block owns a tile of output positions and a block of output channels and
sums every tap on the route of its operand pair (``build.forward_route``:
f32 FMAs for f32 x f32; f32 sums on the bf16 tensor cores for bf16 x
bf16; the TF32 tensor cores for f32 x int8 and bf16 x int8; exact s32
sums on the int8 tensor cores for int8 x int8, the weights K-major),
reading the input through zero-filling copies in place of a host-side
pad; see the note at the top of the source.  Per
launch the wrapper picks the copy widths (``build.copy_variant``) and the
split of the reduction (``tiling.launch_split``) from the real shapes; a
split launch runs a second pass that sums the slices, and still counts
once.  ``launches`` counts the calls that launched the kernel, and
nothing else; ``operand_launches`` records each launch once more by its
``(x, w)`` operand types and the kernel and passes the C entry reports it
launched (``build.record_operands``), e.g. ``("int8", "int8", "s8", 1)``
under int8 activations, and ``staging_launches`` by how it staged A
(``"gather"`` or ``"halo"``: ``tiling.plan_halo`` picks the bf16 x bf16
launches that stage each box of output positions' input footprint once;
a report other than the planner's choice raises).

While a profiler records (``obs.profiled``), the call of the C entry
runs in a ``launch`` span with the launch's plan and its
``build.record_operands`` key.
On a CPU tensor the wrapper runs the plain version (``ref.py``); on a CUDA
tensor it launches the kernel or raises; on a ``meta`` tensor (the dry
run) it returns the output's shape and dtype on ``meta`` and adds the
call and its MACs (each output position, tap and channel pair of its
group) to ``common.dry_tally``, with no launch.
"""

from __future__ import annotations

import math

import torch

from repro_torch import obs as _obs
from repro_torch.core import tiling as _tiling
from repro_torch.kernels import build as _build
from repro_torch.kernels import common as _common
from repro_torch.kernels.conv import ref as _ref

launches = 0
operand_launches: dict[tuple[str, str, str, int], int] = {}
staging_launches: dict[tuple[str, str, str, str], int] = {}


def conv_fwd(x: torch.Tensor, w: torch.Tensor, *, kernel, stride,
             dilation=(1, 1, 1), groups: int = 1, pad_lo=(0, 0, 0),
             out_spatial, scale: torch.Tensor | None = None,
             bias: torch.Tensor | None = None, activation: str = "none",
             alpha: float = 0.2, out_dtype: torch.dtype | None = None,
             block_co: int = 64, split: str = "auto") -> torch.Tensor:
    """Strided correlation on the canonical rank-3 layout.

    x: [N, D, H, W, Ci] (unpadded); w: [prod(K), Ci/G, Co] in kernel-element
    order; both f32, both bf16, or int8 weights beside f32, bf16 or int8 x
    (``build.FORWARD_PAIRS``); beside int8 x the weights come K-major,
    ``common.kmajor_weights`` of stride 1 (``[1, G, Co/G, kp]``).
    ``y[o] = act(scale * sum_k x[o*S + k*dil - lo] w[k] + bias)`` over
    ``out_spatial`` output positions, reads outside x being zero, cast to
    ``out_dtype`` (default x's, f32 for int8 x).  int8 x int8 refuses a
    reduction deeper than ``build.check_s8_depth`` allows.  ``block_co``
    picks the output-channel tile and ``split`` the reduction's policy
    (the plan's, ``tiling.SPLIT_POLICIES``).
    """
    global launches
    kernel, stride = tuple(kernel), tuple(stride)
    dilation, pad_lo = tuple(dilation), tuple(pad_lo)
    out_spatial = tuple(out_spatial)
    if x.dim() != 5 or w.dim() not in (3, 4):
        raise ValueError(f"expected x [N,D,H,W,Ci] and w [taps,Ci/G,Co], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    n, d, h, wd, ci = x.shape
    co = w.shape[-1] if w.dim() == 3 else w.shape[1] * w.shape[2]
    if ci % groups or co % groups or w.shape != _common.weight_shape(
            w.dim() == 4, kernel, (1, 1, 1), dilation, ci // groups, co,
            groups):
        raise ValueError(f"w {tuple(w.shape)} does not fit Ci={ci}, "
                         f"groups={groups}, kernel={kernel}")
    if activation not in _common.ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    if any(o < 0 for o in out_spatial) or any(lo < 0 for lo in pad_lo):
        raise ValueError(f"bad conv extent {out_spatial} / pad {pad_lo}")
    out_dtype = out_dtype or _build.default_out_dtype(x)
    scale32, bias32 = _build.check_operands(x, w, scale, bias, out_dtype,
                                            co=co)
    y = _common.no_sum_result(x, out_spatial, co, bias, activation, alpha,
                              out_dtype)
    if y is not None:
        return y
    route = _build.forward_route(x, w, math.prod(kernel) * (ci // groups))
    if x.device.type == "cpu":
        return _ref.conv_fwd_plain(
            x, w, kernel=kernel, stride=stride, dilation=dilation,
            groups=groups, pad_lo=pad_lo, out_spatial=out_spatial,
            scale=scale, bias=bias, activation=activation, alpha=alpha,
            out_dtype=out_dtype)
    if x.device.type == "meta":
        # each output position, each tap, each channel pair of its group
        macs = n * math.prod(out_spatial) * math.prod(kernel) * (
            ci // groups) * co
        return _common.tally_dry("conv_fwd", macs, (n, *out_spatial, co),
                                 out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no conv kernel for device {x.device}")
    splits, per, copy, halo = _launch_plan(
        x, w, co, kernel, stride, dilation, groups, out_spatial, block_co,
        split, route)
    rows = n * math.prod(out_spatial)
    lib = _build.library()
    y = torch.empty((n, *out_spatial, co), dtype=out_dtype, device=x.device)
    work = _build.split_workspace(splits, rows * co, x.device, route)
    geom = _build.geom_array((n, d, h, wd, ci, co, groups, *kernel, *stride,
                              *dilation, *out_spatial, *out_spatial,
                              *pad_lo, splits, per))
    launched = _build.launched_buffer()
    tel = _obs.profiled(None)
    with (_obs.NO_SPAN if tel is None
          else tel.span("launch", "conv_fwd", block_co=block_co,
                        split=split)) as span:
        err = lib.repro_conv_fwd(
            _build.ptr(x), _build.ptr(w), _build.ptr(scale32),
            _build.ptr(bias32), _build.ptr(y), _build.ptr(work), geom,
            _common.ACTIVATION_CODES[activation], float(alpha),
            _build.DTYPE_CODES[x.dtype], _build.DTYPE_CODES[w.dtype],
            _build.DTYPE_CODES[out_dtype], block_co, copy,
            _build.halo_array(halo), launched, _build.stream_of(x))
        if err:
            raise RuntimeError(f"conv kernel launch failed (cudaError "
                               f"{err})")
        launches += 1
        key = _build.record_operands(operand_launches, x, w, launched,
                                     staging=staging_launches,
                                     halo=halo is not None)
        if span is not None:
            span.set(operands=key)
    return y


def _launch_plan(x, w, co, kernel, stride, dilation, groups, out_spatial,
                 block_co, split, route):
    """A card launch's slices, pairs a slice, copy widths
    (``build.copy_variant``) and halo staging (``tiling.plan_halo``, for
    bf16 x bf16 with 16-byte copies of x; else None: the gather)."""
    n, ci = x.shape[0], x.shape[-1]
    plan = _tiling.plan_uniform_tiles(ci, co, mode="conv",
                                      block_co=block_co, groups=groups,
                                      in_dtype_bytes=x.element_size(),
                                      w_dtype_bytes=w.element_size(),
                                      split=split)
    rows = n * math.prod(out_spatial)
    splits, per = _tiling.launch_split(
        plan, rows, math.prod(kernel) * (ci // groups), co, groups)
    copy = _build.copy_variant(x, w, ci // groups, co // groups)
    halo = None
    if route == "bf16" and copy & _build.BF16_COPY_A16:
        halo = _tiling.plan_halo(plan, "conv", out_spatial, kernel, stride,
                                 dilation, ci // groups, splits, n)
    return splits, per, copy, halo


def planned_halo(x: torch.Tensor, w: torch.Tensor, *, kernel, stride,
                 dilation=(1, 1, 1), groups: int = 1, out_spatial,
                 block_co: int = 64, split: str = "auto", **_epilogue):
    """The halo staging (``tiling.HaloPlan``) that ``conv_fwd(x, w, ...)``
    with these arguments takes on the card, or None where it gathers;
    from shapes, types and x's alignment alone (``meta`` tensors will
    do), launching nothing."""
    co = w.shape[-1] if w.dim() == 3 else w.shape[1] * w.shape[2]
    route = _tiling.operand_route(x.element_size(), w.element_size())
    return _launch_plan(x, w, co, tuple(kernel), tuple(stride),
                        tuple(dilation), groups, tuple(out_spatial),
                        block_co, split, route)[3]
