"""Wrappers of the deconv subsystem's hand-written Hopper kernels.

``deconv_fwd`` wraps ``csrc/deconv_fwd.cu``, which replaces the JAX
package's TPU kernel ``deconv_pallas_3d``.  The kernel gathers: each CUDA
block owns one output phase, a tile of phase positions and a block of
output channels, and sums the taps of its phase on the route of its
operand pair (``build.forward_route``): f32 FMAs for f32 x f32, f32 sums
on the bf16 tensor cores for bf16 x bf16, on the TF32 tensor cores for
f32 x int8 (activations split hi + lo) and bf16 x int8, exact s32 sums
on the int8 tensor cores for int8 x int8 (the weights K-major); see the
note at the top of the
source.  Per launch the wrapper picks the copy widths
(``build.copy_variant``) and the split of the reduction
(``tiling.launch_split``, over the deepest phase) from the real shapes; a
split launch runs a second pass that sums the slices, and counts once.

``deconv_dw`` wraps ``csrc/deconv_dw.cu``, which replaces
``deconv_dw_pallas_3d``: the weight gradient of the deconv and, with its
operands swapped, of the conv.  ``deconv_dx`` replaces
``deconv_dx_pallas_3d`` as the JAX package wrote it, a channel-role swap
over the conv kernel (``conv.kernel.conv_fwd``).

``launches``, ``dw_launches`` and ``dx_launches`` count the calls of each
wrapper that launched its kernel on the card, and nothing else (a
``deconv_dx`` call also counts one ``conv_fwd`` launch).
``operand_launches`` records each ``deconv_fwd`` launch once more by its
``(x, w)`` operand types and the kernel and passes the C entry reports it
launched (``build.record_operands``), e.g. ``("float32", "int8", "tf32",
2)`` for int8 weights, and ``staging_launches`` by how it staged A, e.g.
``("bfloat16", "bfloat16", "bf16", "halo")``: a bf16 x bf16 launch runs
``csrc/deconv_wgmma.cu`` (TMA boxes of the cropped phase grid, wgmma)
where ``tiling.plan_wgmma`` says so (deep channels, stride 2, unsplit,
aligned), else stages each box of rows' input footprint once where
``tiling.plan_halo`` says so (x 16-byte aligned), else gathers; a report
other than the planner's choice raises.
While a profiler records (``obs.profiled``), each wrapper's call of
its C entry runs in a ``launch`` span with the launch's plan and, for the
forward, its ``build.record_operands`` key, and each wgmma launch counts
one in the profiling recorder's ``wgmma_launches_total{op="deconv"}``.
On a CPU tensor each wrapper runs the plain version (``ref.py``); on a
CUDA tensor it launches the kernel or raises; on a ``meta`` tensor (the
dry run) it returns the kernel's output shape and dtype on ``meta`` and
adds the call and the MACs its kernel would execute to
``common.dry_tally`` (the valid MACs, no inserted zero: each input
position times each tap, ``functional.deconv_macs``), neither running
the plain version nor launching.
"""

from __future__ import annotations

import math

import torch

from repro_torch import obs as _obs
from repro_torch.core import tiling as _tiling
from repro_torch.core.functional import deconv_macs, deconv_output_shape
from repro_torch.core.tiling import DW_KERNEL_TILES, split_rows
from repro_torch.kernels import build as _build
from repro_torch.kernels import common as _common
from repro_torch.kernels.deconv import ref as _ref

launches = 0
dw_launches = 0
dx_launches = 0
operand_launches: dict[tuple[str, str, str, int], int] = {}
staging_launches: dict[tuple[str, str, str, str], int] = {}


def deconv_fwd(x: torch.Tensor, w_taps: torch.Tensor, *, kernel, stride,
               dilation=(1, 1, 1), groups: int = 1, crop_lo=(0, 0, 0),
               out_spatial=None, scale: torch.Tensor | None = None,
               bias: torch.Tensor | None = None, activation: str = "none",
               alpha: float = 0.2, out_dtype: torch.dtype | None = None,
               block_co: int = 64, split: str = "auto") -> torch.Tensor:
    """Polyphase IOM deconv on the canonical rank-3 layout.

    x: [N, D, H, W, Ci]; w_taps: [prod(K), Ci/G, Co] in the phase-major
    order of ``common.phase_major_tap_index``; both f32, both bf16, or int8
    weights beside f32, bf16 or int8 x (``build.FORWARD_PAIRS``); beside
    int8 x the weights come K-major (``common.kmajor_weights``,
    ``[prod(S), G, Co/G, kp]``), no phase deeper than
    ``build.check_s8_depth`` allows.  The
    output is the Eq. (1) extent with ``crop_lo`` rows removed in front of
    each dim, cut to ``out_spatial`` (default: the rest of the extent),
    then ``act(acc * scale + bias)`` cast to ``out_dtype`` (default x's,
    f32 for int8 x); ``scale`` is the per-cout dequant scale.
    The window may reach past the Eq. (1) extent (a conv's dx over input
    rows no tap reads); rows there hold the epilogue of a zero sum.
    ``block_co`` picks the kernel's output-channel tile and ``split`` the
    reduction's policy (the plan's, ``tiling.SPLIT_POLICIES``).
    """
    kernel, stride = tuple(kernel), tuple(stride)
    dilation, crop_lo = tuple(dilation), tuple(crop_lo)
    if x.dim() != 5 or w_taps.dim() not in (3, 4):
        raise ValueError(f"expected x [N,D,H,W,Ci] and w_taps [taps,Ci/G,Co],"
                         f" got {tuple(x.shape)} and {tuple(w_taps.shape)}")
    n, d, h, wd, ci = x.shape
    kmajor = w_taps.dim() == 4
    co = w_taps.shape[1] * w_taps.shape[2] if kmajor else w_taps.shape[-1]
    if ci % groups or co % groups or w_taps.shape != _common.weight_shape(
            kmajor, kernel, stride, dilation, ci // groups, co, groups):
        raise ValueError(f"w_taps {tuple(w_taps.shape)} does not fit "
                         f"Ci={ci}, groups={groups}, kernel={kernel}")
    if activation not in _common.ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    full = deconv_output_shape((d, h, wd), kernel, stride, 0, dilation)
    if out_spatial is None:
        out_spatial = tuple(f - lo for f, lo in zip(full, crop_lo))
    out_spatial = tuple(out_spatial)
    if any(lo < 0 or o < 0 for lo, o in zip(crop_lo, out_spatial)):
        raise ValueError(f"crop {crop_lo} / extent {out_spatial} is not a "
                         f"window of the Eq. (1) extent {full}")
    out_dtype = out_dtype or _build.default_out_dtype(x)
    scale32, bias32 = _build.check_operands(x, w_taps, scale, bias,
                                            out_dtype, co=co)
    y = _common.no_sum_result(x, out_spatial, co, bias, activation, alpha,
                              out_dtype)
    if y is not None:
        return y
    deepest = max(len(t) for t in _common.kmajor_phase_taps(kernel, stride,
                                                            dilation))
    route = _build.forward_route(x, w_taps, deepest * (ci // groups))
    if x.device.type == "cpu":
        return _ref.deconv_fwd_plain(
            x, w_taps, kernel=kernel, stride=stride, dilation=dilation,
            groups=groups, crop_lo=crop_lo, out_spatial=out_spatial,
            scale=scale, bias=bias, activation=activation, alpha=alpha,
            out_dtype=out_dtype)
    if x.device.type == "meta":
        return _common.tally_dry(
            "deconv_fwd", deconv_macs((d, h, wd), kernel, ci // groups, co,
                                      batch=n),
            (n, *out_spatial, co), out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no deconv kernel for device {x.device}")
    q, splits, per, copy, halo, wg = _launch_plan(
        x, w_taps, co, kernel, stride, dilation, groups, crop_lo,
        out_spatial, block_co, split, route)
    rows, phases = n * math.prod(q), math.prod(stride)
    taps = _common.tap_table(kernel, stride, dilation, x.device)
    y = torch.empty((n, *out_spatial, co), dtype=out_dtype, device=x.device)
    work = _build.split_workspace(splits, phases * rows * co, x.device,
                                  route)
    geom = (n, d, h, wd, ci, co, groups, *kernel, *stride, *dilation, *q,
            *out_spatial, *crop_lo, splits, per)
    return _launch(_build.library(), x, w_taps, taps, scale32, bias32, y,
                   work, geom, activation, alpha, block_co, split, copy,
                   halo, wg)


def _launch(lib, x, w_taps, taps, scale32, bias32, y, work, geom,
            activation, alpha, block_co, split, copy, halo, wg):
    """One call of the C entry ``repro_deconv_fwd`` into ``y`` with the
    planner's halo (``tiling.HaloPlan``) or wgmma (``tiling.WgmmaPlan``)
    staging, either or both None; recorded in ``operand_launches`` and
    ``staging_launches``.  While a profiler records (``obs.profiled``) it
    runs in a ``launch`` span, and a wgmma launch counts one in the
    profiling recorder's ``wgmma_launches_total{op="deconv"}``."""
    global launches
    launched = _build.launched_buffer()
    tel = _obs.profiled(None)
    with (_obs.NO_SPAN if tel is None
          else tel.span("launch", "deconv_fwd", block_co=block_co,
                        split=split)) as span:
        err = lib.repro_deconv_fwd(
            _build.ptr(x), _build.ptr(w_taps), _build.ptr(taps),
            _build.ptr(scale32), _build.ptr(bias32), _build.ptr(y),
            _build.ptr(work), _build.geom_array(geom),
            _common.ACTIVATION_CODES[activation], float(alpha),
            _build.DTYPE_CODES[x.dtype], _build.DTYPE_CODES[w_taps.dtype],
            _build.DTYPE_CODES[y.dtype], block_co, copy,
            _build.halo_array(halo), _build.wgmma_array(wg), launched,
            _build.stream_of(x))
        if err:
            raise RuntimeError(f"deconv kernel launch failed (cudaError "
                               f"{err})")
        launches += 1
        key = _build.record_operands(operand_launches, x, w_taps, launched,
                                     staging=staging_launches,
                                     halo=halo is not None,
                                     wgmma=wg is not None)
        if span is not None:
            span.set(operands=key)
    if wg is not None and tel is not None:
        tel.counter("wgmma_launches_total", op="deconv").inc()
    return y


def _launch_plan(x, w_taps, co, kernel, stride, dilation, groups, crop_lo,
                 out_spatial, block_co, split, route):
    """A card launch's phase grid q, slices, pairs a slice, copy widths
    (``build.copy_variant``), halo staging (``tiling.plan_halo``, for
    bf16 x bf16 with 16-byte copies of x; else None: the gather) and
    wgmma staging (``tiling.plan_wgmma``, which the planner tries first;
    where it gives one the halo staging is None)."""
    n, d, h, wd, ci = x.shape
    plan = _tiling.plan_uniform_tiles(ci, co, mode="deconv",
                                      block_co=block_co, groups=groups,
                                      in_dtype_bytes=x.element_size(),
                                      w_dtype_bytes=w_taps.element_size(),
                                      split=split)
    q = _ref.phase_rows((d, h, wd), kernel, stride, dilation, crop_lo,
                        out_spatial)
    rows, phases = n * math.prod(q), math.prod(stride)
    depth = math.prod(_common.phase_geometry(kernel, stride, dilation)) * (
        ci // groups)
    splits, per = _tiling.launch_split(plan, rows, depth, co, groups, phases)
    copy = _build.copy_variant(x, w_taps, ci // groups, co // groups)
    halo = wg = None
    if route == "bf16":
        wg = _tiling.plan_wgmma(
            kernel, stride, dilation, crop_lo, tuple(out_spatial),
            ci // groups, co // groups, groups, splits, n,
            aligned=x.data_ptr() % 16 == 0 and w_taps.data_ptr() % 16 == 0)
    if wg is None and route == "bf16" and copy & _build.BF16_COPY_A16:
        halo = _tiling.plan_halo(plan, "deconv", q, kernel, stride, dilation,
                                 ci // groups, splits, n)
    return q, splits, per, copy, halo, wg


def planned_halo(x: torch.Tensor, w_taps: torch.Tensor, *, kernel, stride,
                 dilation=(1, 1, 1), groups: int = 1, crop_lo=(0, 0, 0),
                 out_spatial=None, block_co: int = 64, split: str = "auto",
                 **_epilogue):
    """The halo staging (``tiling.HaloPlan``) that ``deconv_fwd(x, w_taps,
    ...)`` with these arguments takes on the card, or None where it
    gathers or takes the wgmma route (``planned_wgmma``); from shapes,
    types and x's alignment alone (``meta`` tensors will do), launching
    nothing."""
    return _planned(x, w_taps, kernel, stride, dilation, groups, crop_lo,
                    out_spatial, block_co, split)[4]


def planned_wgmma(x: torch.Tensor, w_taps: torch.Tensor, *, kernel, stride,
                  dilation=(1, 1, 1), groups: int = 1, crop_lo=(0, 0, 0),
                  out_spatial=None, block_co: int = 64, split: str = "auto",
                  **_epilogue):
    """The wgmma staging (``tiling.WgmmaPlan``) that ``deconv_fwd(x,
    w_taps, ...)`` with these arguments takes on the card, or None where
    it gathers or stages a halo; as ``planned_halo``, launching
    nothing."""
    return _planned(x, w_taps, kernel, stride, dilation, groups, crop_lo,
                    out_spatial, block_co, split)[5]


def _planned(x, w_taps, kernel, stride, dilation, groups, crop_lo,
             out_spatial, block_co, split):
    """``_launch_plan`` of ``deconv_fwd``'s arguments."""
    kernel, stride = tuple(kernel), tuple(stride)
    dilation, crop_lo = tuple(dilation), tuple(crop_lo)
    co = (w_taps.shape[1] * w_taps.shape[2] if w_taps.dim() == 4
          else w_taps.shape[-1])
    if out_spatial is None:
        full = deconv_output_shape(tuple(x.shape[1:4]), kernel, stride, 0,
                                   dilation)
        out_spatial = tuple(f - lo for f, lo in zip(full, crop_lo))
    route = _tiling.operand_route(x.element_size(), w_taps.element_size())
    return _launch_plan(x, w_taps, co, kernel, stride, dilation, groups,
                        crop_lo, tuple(out_spatial), block_co, split, route)


def deconv_dw(a: torch.Tensor, b: torch.Tensor, *, kernel, stride,
              dilation=(1, 1, 1), groups: int = 1, lo=(0, 0, 0),
              transpose: bool = False, out_dtype: torch.dtype | None = None,
              block_a: int = 64, block_c: int = 128,
              splits: int = 1) -> torch.Tensor:
    """Weight gradient on the canonical rank-3 layout.

    ``out[t, i, g*Bg + j] = sum_p a[p, g*Ag + i] * b[p*S + k_t*dil - lo,
    g*Bg + j]`` over every position p of a (batch included), reads of b
    outside its extent zero, taps in kernel-element order.  a: [N, D, H,
    W, Ac]; b: [N, *, *, *, Bc] of a's dtype.  Returns [prod(K), Ac/G, Bc]
    in ``out_dtype`` (default a's), or [prod(K), Bc/G, Ac] stored
    ``[t, j, g*Ag + i]`` when ``transpose``.  The deconv's dw is
    ``(a, b) = (x, dy)`` with ``lo`` its crop; the conv's is
    ``(dy, x)`` with ``lo`` its pad and ``transpose``.  ``block_a`` x
    ``block_c`` (the tile) and ``splits`` are the planner's
    (``tiling.plan_dw_tiles``); the copy widths are picked here
    (``build.dw_vector_copies``).
    """
    global dw_launches
    kernel, stride = tuple(kernel), tuple(stride)
    dilation, lo = tuple(dilation), tuple(lo)
    if a.dim() != 5 or b.dim() != 5 or a.shape[0] != b.shape[0]:
        raise ValueError(f"expected a [N,D,H,W,Ac] and b [N,*,*,*,Bc], got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    ac, bc = a.shape[-1], b.shape[-1]
    if ac % groups or bc % groups:
        raise ValueError(f"groups={groups} must divide {ac} and {bc}")
    if any(v < 0 for v in lo):
        raise ValueError(f"negative offset {lo}")
    out_dtype = out_dtype or a.dtype
    _build.check_operands(a, b, None, None, out_dtype, co=bc,
                          pairs=_build.FLOAT_PAIRS)
    if a.device.type == "cpu":
        return _ref.deconv_dw_plain(
            a, b, kernel=kernel, stride=stride, dilation=dilation,
            groups=groups, lo=lo, transpose=transpose, out_dtype=out_dtype)
    if a.device.type == "meta":
        # each of a's positions, each tap, its group's channel pairs
        taps = math.prod(kernel)
        macs = a.shape[0] * math.prod(a.shape[1:4]) * taps * ac * bc // groups
        return _common.tally_dry("deconv_dw", macs, (
            (taps, bc // groups, ac) if transpose
            else (taps, ac // groups, bc)), out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"no dw kernel for device {a.device}")
    if (block_a, block_c) not in DW_KERNEL_TILES:
        raise ValueError(f"tile {block_a}x{block_c} not in "
                         f"{sorted(DW_KERNEL_TILES)}")
    n = a.shape[0]
    rows = n * math.prod(a.shape[1:4])
    splits, per = split_rows(rows, splits)
    taps = math.prod(kernel)
    shape = ((taps, bc // groups, ac) if transpose
             else (taps, ac // groups, bc))
    out = torch.empty(shape, dtype=out_dtype, device=a.device)
    work = (torch.empty(splits * out.numel(), dtype=torch.float32,
                        device=a.device) if splits > 1 else None)
    geom = _build.geom_array((n, *a.shape[1:4], ac, *b.shape[1:4], bc,
                              groups, *kernel, *stride, *dilation, *lo, per,
                              int(bool(transpose))), fields=24)
    vec_a, vec_b = _build.dw_vector_copies(a, b, ac // groups, bc // groups)
    lib = _build.library()
    tel = _obs.profiled(None)
    with (_obs.NO_SPAN if tel is None
          else tel.span("launch", "deconv_dw", block_a=block_a,
                        block_c=block_c, splits=splits)):
        err = lib.repro_deconv_dw(
            _build.ptr(a), _build.ptr(b), _build.ptr(out), _build.ptr(work),
            geom, splits, block_a, block_c, _build.DTYPE_CODES[a.dtype],
            _build.DTYPE_CODES[out_dtype], int(vec_a), int(vec_b),
            _build.stream_of(a))
        if err:
            raise RuntimeError(f"dw kernel launch failed (cudaError {err})")
        dw_launches += 1
    return out


def deconv_dx(dy: torch.Tensor, w_dx: torch.Tensor, *, kernel, stride,
              dilation=(1, 1, 1), groups: int = 1, pad_lo=(0, 0, 0),
              out_spatial, out_dtype: torch.dtype | None = None,
              block_co: int = 64) -> torch.Tensor:
    """The deconv's input gradient: the conv kernel with the channel roles
    swapped, ``dx[i] = sum_k dy[i*S + k*dil - lo] w[k]^T``.

    dy: [N, *out, Co], the cotangent of the cropped output; w_dx:
    [prod(K), Co/G, Ci] in kernel-element order (``common.regroup_for_dx``
    of the forward's weights), so the conv contracts Co within each group
    and produces all of Ci.  The crop's ``lo`` is the conv's ``pad_lo``
    and ``out_spatial`` is x's extent; reads of dy outside its extent are
    zero.  ``block_co`` tiles Ci (the dx plan's).  The arguments are
    ``conv.kernel.conv_fwd``'s, and so is the plain version.
    """
    global dx_launches
    from repro_torch.kernels.conv import kernel as _conv_k  # cycle-free
    dx = _conv_k.conv_fwd(dy, w_dx, kernel=kernel, stride=stride,
                          dilation=dilation, groups=groups, pad_lo=pad_lo,
                          out_spatial=out_spatial, out_dtype=out_dtype,
                          block_co=block_co)
    if dy.device.type == "cuda":
        dx_launches += 1
    elif dy.device.type == "meta":
        _common.count_dry("deconv_dx", 0)     # its MACs are conv_fwd's
    return dx
