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
    matrix for the deconv kernel's implicit GEMM.

Everything here is pure Python or plain tensor code.
"""

from __future__ import annotations

import functools
import itertools
import math

import torch

from repro_torch.core.functional import _canon


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
    if rank == 3:
        return x, w, tuple(stride), ()
    if rank == 2:
        x3 = x.reshape(x.shape[0], x.shape[1], 1, x.shape[2], x.shape[3])
        w3 = w.reshape(w.shape[0], 1, w.shape[1], w.shape[2], w.shape[3])
        return x3, w3, (stride[0], 1, stride[1]), (2,)
    x3 = x.reshape(x.shape[0], 1, 1, x.shape[1], x.shape[2])
    w3 = w.reshape(1, 1, *w.shape)
    return x3, w3, (1, 1, stride[0]), (1, 2)


def lift_padding(pads, rank):
    """Lift per-dim (lo, hi) pairs onto the canonical 3D layout."""
    if rank == 3:
        return tuple(pads)
    if rank == 2:
        return (pads[0], (0, 0), pads[1])
    return ((0, 0), (0, 0), pads[0])


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
