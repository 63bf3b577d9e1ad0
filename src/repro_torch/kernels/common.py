"""Shared polyphase geometry for the uniform conv/deconv engine (PyTorch).

A stride-S deconv scatters each input activation through the S^d output
phases; its adjoint, a stride-S convolution, gathers the same taps back.
The static bookkeeping of that correspondence lives here, so the deconv
and conv kernels and their plain versions cannot drift:

  * ``phase_geometry`` — taps per phase per dim, ``M = ((K-1)*dil)//S + 1``,
  * ``halo_depth`` — leading-dim phase rows that adjacent tiles overlap,
  * ``phase_taps`` — the (phase, valid taps) table; summed over phases the
    taps number exactly prod(K) (the IOM valid-MAC count),
  * ``phase_major_tap_index`` — the weight order that lands each phase's
    taps contiguously, so one phase's weights are ONE [taps*Cin, Cout]
    matrix for the deconv kernel's implicit GEMM,
  * ``activation_grad_from_output`` and ``regroup_for_dx`` — what the two
    ops' backward passes share,
  * ``relayout`` — each weight re-layout of the ops, in its ``relayout``
    span and counted in ``weight_relayouts_total``.

Everything here is pure Python or plain tensor code.

``dry_tally`` counts the wrappers' calls on ``meta`` tensors (the dry
run's abstract steps), apart from their launch counters: per wrapper,
its calls and the MACs its kernel would execute on those shapes.
"""

from __future__ import annotations

import functools
import itertools
import math

import torch

from repro_torch import obs as _obs
from repro_torch.core.functional import _canon

# the hand-kernel wrappers, as their tallies name them
WRAPPERS = ("deconv_fwd", "conv_fwd", "deconv_dw", "deconv_dx")
_DRY = {name: [0, 0] for name in WRAPPERS}


def dry_tally() -> dict[str, dict[str, int]]:
    """``{wrapper: {"calls", "macs"}}`` of the wrappers' ``meta`` calls
    since ``reset_dry_tally``."""
    return {k: {"calls": v[0], "macs": v[1]} for k, v in _DRY.items()}


def reset_dry_tally() -> None:
    for v in _DRY.values():
        v[0] = v[1] = 0


def count_dry(name: str, macs: int) -> None:
    """One more ``meta`` call of wrapper ``name``, and ``macs`` more MACs."""
    _DRY[name][0] += 1
    _DRY[name][1] += int(macs)


def tally_dry(name: str, macs: int, shape, dtype) -> torch.Tensor:
    """A wrapper's ``meta`` call (``count_dry``) and the kernel's output
    (``shape``, ``dtype``) on ``meta``.  Nothing runs."""
    count_dry(name, macs)
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def canon_dilation(dilation, rank):
    """None / int / seq -> rank-length tuple of per-dim dilation factors."""
    if dilation is None:
        return (1,) * rank
    return _canon(dilation, rank)


def effective_kernel(kernel, dilation=None):
    """Dilated footprint per dim: K_eff = (K - 1) * dil + 1."""
    dil = canon_dilation(dilation, len(kernel))
    return tuple((k - 1) * d + 1 for k, d in zip(kernel, dil))


def _dim_tap_table(k, s, d):
    """Per-dim polyphase map: phase p -> sorted [(m, k_idx), ...].

    Kernel element ``k_idx`` of a dilation-``d`` kernel sits at effective
    offset ``e = k_idx * d``; under stride ``s`` it lands in phase
    ``e % s`` as tap ``m = e // s``.  Some phases may receive no taps at
    all (structural zeros).
    """
    table = {}
    for ki in range(k):
        e = ki * d
        table.setdefault(e % s, []).append((e // s, ki))
    return table


def phase_geometry(kernel, stride, dilation=None):
    """Taps per phase per dim: ``((K-1)*dil) // S + 1`` (ceil(K/S) at
    dil 1)."""
    dil = canon_dilation(dilation, len(kernel))
    return tuple(((k - 1) * d) // s + 1
                 for k, s, d in zip(kernel, stride, dil))


def halo_depth(kernel, stride, dilation=None) -> int:
    """Leading-dim phase rows that adjacent output tiles overlap."""
    return phase_geometry(kernel, stride, dilation)[0] - 1


def phase_taps(kernel, stride, dilation=None):
    """(phase_index, phase, taps) triples, empty phases skipped.

    A tap ``m`` of phase ``p`` touches the kernel element whose effective
    offset is ``e = m*S + p``; each phase's tap list is the cross product
    of the per-dim polyphase tables, in the order ``phase_major_tap_index``
    lays the weights out.
    """
    dil = canon_dilation(dilation, len(kernel))
    tables = [_dim_tap_table(k, s, d)
              for k, s, d in zip(kernel, stride, dil)]
    out = []
    for p_idx, p in enumerate(itertools.product(*(range(s) for s in stride))):
        dim_taps = [t.get(pj) for t, pj in zip(tables, p)]
        if any(dt is None for dt in dim_taps):
            continue  # structural-zero phase (S > K, or dilation gaps)
        taps = [tuple(m for m, _ in combo)
                for combo in itertools.product(*dim_taps)]
        out.append((p_idx, p, taps))
    return out


def phase_major_tap_index(kernel, stride, dilation=None):
    """Flat kernel-element indices ordered phase-major (the weight layout).

    ``w.reshape(prod(K), ci, co)[index]`` puts each phase's valid taps
    contiguously; total length is exactly prod(K).  In lock-step with the
    tap order of ``phase_taps``.
    """
    dil = canon_dilation(dilation, len(kernel))
    tables = [_dim_tap_table(k, s, d)
              for k, s, d in zip(kernel, stride, dil)]
    idx = []
    for p in itertools.product(*(range(s) for s in stride)):
        dim_taps = [t.get(pj) for t, pj in zip(tables, p)]
        if any(dt is None for dt in dim_taps):
            continue
        for combo in itertools.product(*dim_taps):
            flat = 0
            for (_, kj), kk in zip(combo, kernel):
                flat = flat * kk + kj
            idx.append(flat)
    assert len(idx) == math.prod(kernel)
    return idx


def phase_major_inverse(kernel, stride, dilation=None):
    """Inverse permutation of ``phase_major_tap_index``."""
    perm = phase_major_tap_index(kernel, stride, dilation)
    inv = [0] * len(perm)
    for pos, j in enumerate(perm):
        inv[j] = pos
    return inv


@functools.lru_cache(maxsize=256)
def _tap_index(kernel3, stride3, dilation3, device: torch.device):
    idx = phase_major_tap_index(kernel3, stride3, dilation3)
    return torch.tensor(idx, dtype=torch.long, device=device)


def phase_major_weights(w3, kernel3, stride3, dilation3=None):
    """[*K, a, b] -> [prod(K), a, b] in phase-major tap order.

    The index tensor is built once per (geometry, device), so the gather
    is one device-side ``index_select`` per call.
    """
    dilation3 = tuple(dilation3) if dilation3 is not None else (1, 1, 1)
    idx = _tap_index(tuple(kernel3), tuple(stride3), dilation3, w3.device)
    return w3.reshape(-1, *w3.shape[3:]).index_select(0, idx)


@functools.lru_cache(maxsize=256)
def kmajor_phase_taps(kernel3, stride3, dilation3=(1, 1, 1)):
    """Each phase's kernel-element taps in the K-major weight layout, one
    tuple per phase index (``itertools.product`` order, empty for a
    structural-zero phase): the deconv's phase-major order.  A conv is the
    one phase of stride 1, its taps in kernel-element order."""
    flat = phase_major_tap_index(kernel3, stride3, dilation3)
    out = [()] * math.prod(stride3)
    off = 0
    for p_idx, _, taps in phase_taps(kernel3, stride3, dilation3):
        out[p_idx] = tuple(flat[off:off + len(taps)])
        off += len(taps)
    return tuple(out)


def kmajor_pitch(kernel3, stride3, dilation3, cig: int) -> int:
    """Bytes of one K-major weight row: the deepest phase's (tap, channel)
    pairs rounded up to 16 (the int8 route's 16-byte copies)."""
    deepest = max(len(t) for t in kmajor_phase_taps(
        tuple(kernel3), tuple(stride3), tuple(dilation3)))
    return -(-deepest * cig // 16) * 16


@functools.lru_cache(maxsize=256)
def _kmajor_index(kernel3, stride3, dilation3, cig: int,
                  device: torch.device):
    """Row of ``[prod(K) * cig, Co]`` weights (kernel-element taps; row
    ``prod(K) * cig`` is a zero row) for every (phase, pair) of the
    K-major layout."""
    kp = kmajor_pitch(kernel3, stride3, dilation3, cig)
    zero = math.prod(kernel3) * cig
    idx = []
    for taps in kmajor_phase_taps(kernel3, stride3, dilation3):
        rows = [t * cig + c for t in taps for c in range(cig)]
        idx += rows + [zero] * (kp - len(rows))
    return torch.tensor(idx, dtype=torch.long, device=device)


def kmajor_weights(w3, kernel3, stride3, dilation3=None, groups: int = 1):
    """[*K, Cin/G, Cout] -> the int8 route's K-major weights
    ``[phases, G, Cout/G, kp]``: row ``[p, g, c]`` holds phase p's (tap,
    channel) pairs ``t * Cin/G + ci`` (taps in ``kmajor_phase_taps``
    order) of output channel ``g * Cout/G + c``, zero past them up to
    ``kmajor_pitch``.  The conv's layout is the stride-1 one (a single
    phase).  A layout move: one gather and one transposing copy."""
    dilation3 = tuple(dilation3) if dilation3 is not None else (1, 1, 1)
    kernel3, stride3 = tuple(kernel3), tuple(stride3)
    cig, co = w3.shape[-2], w3.shape[-1]
    idx = _kmajor_index(kernel3, stride3, dilation3, cig, w3.device)
    rows = torch.cat([w3.reshape(-1, co), w3.new_zeros((1, co))])
    phases = math.prod(stride3)
    return (rows.index_select(0, idx)
            .reshape(phases, -1, groups, co // groups)
            .permute(0, 2, 3, 1).contiguous())


def weight_shape(kmajor: bool, kernel3, stride3, dilation3, cig: int,
                 co: int, groups: int) -> torch.Size:
    """The weights' shape a forward wrapper takes: ``[prod(K), cig, co]``
    (taps), or K-major ``[prod(S), G, co/G, kmajor_pitch]``."""
    if kmajor:
        return torch.Size((math.prod(stride3), groups, co // groups,
                           kmajor_pitch(kernel3, stride3, dilation3, cig)))
    return torch.Size((math.prod(kernel3), cig, co))


def taps_from_kmajor(wk, kernel3, stride3, dilation3, cig: int):
    """The inverse of ``kmajor_weights`` up to the tap order: ``[taps,
    Cin/G, Cout]`` with each phase's taps in phase-major order (the deconv
    kernel's ``w_taps``; kernel-element order for the stride-1 layout)."""
    _, groups, cog, _ = wk.shape
    slabs = []
    for p, taps in enumerate(kmajor_phase_taps(tuple(kernel3), tuple(stride3),
                                               tuple(dilation3))):
        if taps:
            slab = wk[p, :, :, :len(taps) * cig].reshape(groups, cog,
                                                         len(taps), cig)
            slabs.append(slab.permute(2, 3, 0, 1).reshape(
                len(taps), cig, groups * cog))
    return torch.cat(slabs).contiguous()


@functools.lru_cache(maxsize=256)
def tap_table(kernel3, stride3, dilation3, device: torch.device):
    """The deconv kernel's int32 tap table on ``device``.

    Layout: ``[start_p, count_p]`` for every phase index p in
    ``itertools.product`` order (count 0 for structural-zero phases), then
    ``(m_d, m_h, m_w)`` for every tap in phase-major order — the rows of
    ``phase_major_weights``.
    """
    n_phases = math.prod(stride3)
    heads = [0, 0] * n_phases
    offsets = []
    for p_idx, _, taps in phase_taps(kernel3, stride3, dilation3):
        heads[2 * p_idx] = len(offsets)
        heads[2 * p_idx + 1] = len(taps)
        offsets.extend(taps)
    flat = heads + [m for tap in offsets for m in tap]
    return torch.tensor(flat, dtype=torch.int32, device=device)


# -- Fused epilogue (scale + bias + activation in the kernel's store) --------

ACTIVATIONS = ("none", "relu", "leaky_relu", "tanh")
ACTIVATION_CODES = {a: i for i, a in enumerate(ACTIVATIONS)}


def apply_epilogue(y, bias, activation, alpha=0.2, scale=None):
    """Scale -> bias -> activation on a completed f32 accumulator.

    ``scale`` (per output channel) multiplies first so the bias stays in
    real units; both broadcast over every dim but the trailing channels.
    relu and leaky_relu propagate NaN, as ``jnp.maximum``/``jnp.where`` do.
    """
    if scale is not None:
        y = y * scale.reshape(-1).to(y.dtype)
    if bias is not None:
        y = y + bias.reshape(-1).to(y.dtype)
    if activation == "relu":
        y = torch.maximum(y, torch.zeros((), dtype=y.dtype, device=y.device))
    elif activation == "leaky_relu":
        y = torch.where(y > 0, y, alpha * y)
    elif activation == "tanh":
        y = torch.tanh(y)
    elif activation != "none":
        raise ValueError(f"unknown activation {activation!r}")
    return y


def no_sum_result(x, out_spatial, co, bias, activation, alpha, out_dtype):
    """What a forward wrapper returns without a launch when its window
    holds no sum: x or the ``[N, *out_spatial, Co]`` output has no
    position.  The output is then empty, or the epilogue of a zero sum
    (a scale leaves zero as it is).  None when there is a sum to run."""
    if x.numel() and math.prod(out_spatial):
        return None
    y = torch.zeros((x.shape[0], *out_spatial, co), dtype=torch.float32,
                    device=x.device)
    return apply_epilogue(y, bias, activation, alpha).to(out_dtype)


def activation_grad_from_output(y, activation, alpha=0.2):
    """d(act)/d(pre-activation) computed from the *output* y = act(pre).

    relu and leaky_relu keep the sign of the pre-activation and
    tanh' = 1 - y^2, so the saved output is the only residual a fused
    epilogue needs.  Returns None for the identity.
    """
    if activation == "relu":
        return (y > 0).to(y.dtype)
    if activation == "leaky_relu":
        return torch.where(y > 0, torch.ones_like(y),
                           torch.full_like(y, alpha))
    if activation == "tanh":
        return (1 - y * y).to(y.dtype)
    return None


def regroup_for_dx(w_flat, groups):
    """[taps, Ci/G, Co] -> [taps, Co/G, Ci]: the weights of an op's dx,
    which contracts Co within each group and produces all of Ci
    (``w[t, i, g*Cog + c]`` lands at ``[t, c, g*Cig + i]``)."""
    taps, cig, co = w_flat.shape
    cog = co // groups
    return (w_flat.reshape(taps, cig, groups, cog).permute(0, 3, 2, 1)
            .reshape(taps, cog, groups * cig).contiguous())


def relayout(engine, op: str, kernel3, stride3, layout, w, *args):
    """``layout(w, *args)``: one re-layout of an ``op``'s (``"conv"`` or
    ``"deconv"``) weights (``phase_major_weights``, ``kmajor_weights``,
    ``regroup_for_dx``).  Where ``obs.active`` finds a recorder for the
    engine it counts one in ``weight_relayouts_total{op}``, and while a
    profiler records it runs in a ``relayout`` span of the layer's
    kernel, stride and dtype."""
    tel = _obs.active(engine.config.telemetry)
    if tel is None:
        return layout(w, *args)
    tel.counter("weight_relayouts_total", op=op).inc()
    if not _obs.profiler_recording():
        return layout(w, *args)
    with tel.span("relayout", layout.__name__, op=op, kernel=kernel3,
                  stride=stride3, dtype=str(w.dtype).split(".")[-1]):
        return layout(w, *args)


# -- Host-side canonicalisation shared by both ops layers --------------------

def lift_tuple3(vals, rank, fill=1):
    """Lift a rank-length per-dim tuple to rank 3 the way ``lift_3d`` lifts
    activations: rank 2 puts the singleton in the MIDDLE, rank 1 leads with
    two."""
    vals = tuple(vals)
    if rank == 3:
        return vals
    if rank == 2:
        return (vals[0], fill, vals[1])
    return (fill, fill, vals[0])


def lift_3d(x, w, stride):
    """Canonicalise rank-1/2 inputs to rank 3; returns the squeeze dims.

    Rank 2 lifts [N, H, W, C] -> [N, H, 1, W, C] (singleton in the MIDDLE)
    and weights [Kh, Kw, a, b] -> [Kh, 1, Kw, a, b]; rank 1 lifts to
    [N, 1, 1, W, C].  Both are views of contiguous inputs.
    """
    rank = x.dim() - 2
    stride = _canon(stride, rank)
    x3 = lift_activation(x)
    if rank == 3:
        return x3, w, tuple(stride), ()
    if rank == 2:
        w3 = w.reshape(w.shape[0], 1, w.shape[1], w.shape[2], w.shape[3])
        return x3, w3, (stride[0], 1, stride[1]), (2,)
    w3 = w.reshape(1, 1, *w.shape)
    return x3, w3, (1, 1, stride[0]), (1, 2)


def lift_activation(t):
    """[N, *spatial, C] -> the rank-3 layout ``lift_3d`` gives x (a view
    of a contiguous tensor)."""
    rank = t.dim() - 2
    if rank == 3:
        return t
    if rank == 2:
        return t.reshape(t.shape[0], t.shape[1], 1, t.shape[2], t.shape[3])
    return t.reshape(t.shape[0], 1, 1, t.shape[1], t.shape[2])


def lift_padding(pads, rank):
    """Lift per-dim (lo, hi) pairs onto the canonical 3D layout."""
    if rank == 3:
        return tuple(pads)
    if rank == 2:
        return (pads[0], (0, 0), pads[1])
    return ((0, 0), (0, 0), pads[0])


def padded_extent(spatial, pads):
    """A conv input's extent with its (lo, hi) pads added: the spatial
    part of a conv's plan key, as the JAX planner keys it."""
    return tuple(i + lo + hi for i, (lo, hi) in zip(spatial, pads))


def unlift_shape(n, out3, co, squeeze):
    """The op-level output shape of a lifted result: drop the singleton
    dims ``lift_3d`` inserted (``squeeze``, as tensor dims)."""
    return (n, *(o for i, o in enumerate(out3) if i + 1 not in squeeze), co)


def scale_vector(w_scale, co):
    """A per-cout (or scalar) dequant scale as ``co`` f32 values."""
    if w_scale is None:
        return None
    s = w_scale.reshape(-1).to(torch.float32)
    return s.expand(co) if s.numel() == 1 else s


# -- What both ops' backward passes share -------------------------------------

def wants_grad(*tensors) -> bool:
    """Whether an op call must record its autograd ``Function``."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def check_float_backward(x):
    """The backward takes float activations only, as the reference's does:
    int8 weights are dequantized for it (``dequantized``), quantized
    activations raise."""
    if not x.dtype.is_floating_point:
        raise NotImplementedError(
            "backward through quantized activations is not supported; "
            "train with Precision(act_quant='none')")


def peel_epilogue(dy, y, bias, activation, alpha, need_db):
    """Undo the fused epilogue on the cotangent: the activation gradient
    from the saved output, then ``db`` as a sum over every non-channel
    axis (None unless ``need_db``)."""
    grad = activation_grad_from_output(y, activation, alpha)
    if grad is not None:
        dy = dy * grad
    db = (dy.sum(dim=tuple(range(dy.dim() - 1))).to(bias.dtype)
          if need_db and bias is not None else None)
    return dy, db


def dequantized(w, w_scale):
    """The weights the backward contracts with: ``w * w_scale`` in f32 when
    the forward fused a scale (it commutes with the contractions)."""
    if w_scale is None:
        return w
    return w.to(torch.float32) * w_scale.to(torch.float32)


def fold_scale(dw, w, w_scale):
    """Chain the dequantized weights' gradient ``dw`` back to the stored
    weights and the scale: ``(dw * w_scale, sum(w * dw))``, the scale's
    gradient summed per output channel (or over everything for a scalar
    scale).  Integer (int8) weights take no gradient: None."""
    if w_scale is None:
        return dw, None
    full = w.to(torch.float32) * dw
    if w_scale.dim() == 0:
        dscale = full.sum()
    else:
        dscale = full.sum(dim=tuple(range(full.dim() - 1))).reshape(
            w_scale.shape)
    dw_stored = ((dw * w_scale).to(w.dtype) if w.dtype.is_floating_point
                 else None)
    return dw_stored, dscale.to(w_scale.dtype)


def op_forward(ctx, forward, x, w, b, w_scale, *args):
    """The forward both ops' autograd ``Function``s run: ``forward(x, w,
    b, w_scale, *args)`` with ``args`` = (stride, padding, dilation,
    groups, activation, alpha, engine).  The activation gradient is
    recoverable from the output, so y is the only extra residual, and
    only when an activation is fused."""
    y = forward(x, w, b, w_scale, *args)
    ctx.save_for_backward(x, w, b, w_scale, y if args[4] != "none" else None)
    ctx.args = args
    return y


def op_backward(ctx, op: str, dy, backward_args, dx_kernel, dw_kernel):
    """The backward both ops' autograd ``Function``s run: peel the fused
    epilogue, contract with the dequantized weights, launch dx only when
    x wants a gradient and dw when w or the scale does, then fold the
    scale back.  ``backward_args`` gives the launches' arguments
    (``deconv_backward_args`` / ``conv_backward_args``), built only for
    the launches that follow; ``ctx`` holds ``(x, w, bias, w_scale, y)``
    and the op's non-tensor arguments.  Returns the Function's gradients
    (x, w, bias, w_scale, then None for the seven non-tensor
    arguments).  Where ``obs.profiled`` finds a recorder for the engine
    it runs in a ``node_backward`` span of the ``op`` and its shapes."""
    x, w, b, w_scale, y = ctx.saved_tensors
    engine = ctx.args[-1]
    tel = _obs.profiled(engine.config.telemetry)
    with (_obs.NO_SPAN if tel is None
          else tel.span("node_backward", op, x=tuple(x.shape),
                        w=tuple(w.shape), dy=tuple(dy.shape))):
        return _op_backward(ctx, dy, backward_args, dx_kernel, dw_kernel,
                            x, w, b, w_scale, y)


def _op_backward(ctx, dy, backward_args, dx_kernel, dw_kernel, x, w, b,
                 w_scale, y):
    stride, padding, dilation, groups, activation, alpha, engine = ctx.args
    need_x, need_w, need_b, need_s = ctx.needs_input_grad[:4]
    check_float_backward(x)
    dy, db = peel_epilogue(dy, y, b, activation, alpha, need_b)
    dx = dw = dscale = None
    if not (need_x or need_w or need_s):
        return (dx, dw, db, dscale) + (None,) * 7
    if not (x.numel() and dy.numel()):
        # a window that held no sum: nothing reached y from x or w, so
        # both gradients are zeros and no kernel runs
        if need_x:
            dx = torch.zeros_like(x)
        if need_w or need_s:
            wd = dequantized(w, w_scale)
            dw, dscale = fold_scale(torch.zeros_like(wd), w, w_scale)
        return (dx, dw, db, dscale) + (None,) * 7
    dx_args, dw_args = backward_args(
        x, dequantized(w, w_scale), dy, stride, padding, dilation=dilation,
        groups=groups, engine=engine, dx=need_x, dw=need_w or need_s)
    if need_x:
        a, b_, kw = dx_args
        dx = dx_kernel(a, b_, **kw).reshape(x.shape)
    if need_w or need_s:
        a, b_, kw = dw_args
        dw, dscale = fold_scale(dw_kernel(a, b_, **kw).reshape(w.shape), w,
                                w_scale)
    return (dx, dw, db, dscale) + (None,) * 7
