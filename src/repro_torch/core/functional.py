"""Deconvolution semantics shared by the engine and both ops layers.

Canonical semantics (channels-last, VALID):

    y[n, o, co] = sum_{i, k : o = i*S + k*dil} x[n, i, ci] * w[k, ci, co]

with ``o``/``i``/``k`` multi-indices over the spatial rank.  The output
extent is Eq. (1) of the paper, ``O = (I - 1) * S + (K - 1) * dil + 1`` per
dim; ``padding`` then crops ``(lo, hi)`` elements from the borders.

Only the hand-kernel method (``"pallas"``, the name the JAX package gives
its kernel path) exists in the port so far; the reference's XLA-lowered
flavours are listed in ``METHODS`` so that a caller naming one gets a typed
error that says where it will come from.
"""

from __future__ import annotations

import math
from typing import Sequence

Ints = Sequence[int]

METHODS = ("oom", "xla", "iom", "iom_phase", "pallas")
# methods the port runs today; the others wait for ROADMAP item 2
PORTED_METHODS = ("pallas",)


def _canon(v, rank: int) -> tuple[int, ...]:
    if isinstance(v, int):
        return (v,) * rank
    v = tuple(int(u) for u in v)
    if len(v) != rank:
        raise ValueError(f"expected {rank} per-dim values, got {v}")
    return v


def canon_padding(padding, rank: int) -> tuple[tuple[int, int], ...]:
    """Canonicalise ``padding`` to ``((lo, hi), ...)`` per spatial dim.

    Accepts a scalar (symmetric everywhere), or a length-``rank`` sequence
    whose entries are scalars (symmetric per dim) or ``(lo, hi)`` pairs.
    """
    if isinstance(padding, int):
        return ((padding, padding),) * rank
    padding = tuple(padding)
    if len(padding) != rank:
        raise ValueError(f"padding {padding} does not have {rank} entries")
    out = []
    for p in padding:
        try:
            pi = int(p)
            out.append((pi, pi))
        except TypeError:
            lo, hi = p
            out.append((int(lo), int(hi)))
    return tuple(out)


def deconv_output_shape(in_spatial: Ints, kernel: Ints, stride: Ints,
                        padding=0, dilation: Ints | int = 1,
                        ) -> tuple[int, ...]:
    """Eq. (1): O = (I-1)*S + K_eff, then crop ``padding`` from the borders."""
    rank = len(in_spatial)
    kernel = _canon(kernel, rank)
    stride = _canon(stride, rank)
    dilation = _canon(dilation, rank)
    pads = canon_padding(padding, rank)
    return tuple((i - 1) * s + (k - 1) * d + 1 - lo - hi
                 for i, k, s, d, (lo, hi) in zip(in_spatial, kernel, stride,
                                                 dilation, pads))


def conv_output_shape(in_spatial, kernel, stride, padding=0, dilation=1):
    """Per-dim conv output extent ``O = (I + lo + hi - K_eff) // S + 1``."""
    rank = len(in_spatial)
    kernel = _canon(kernel, rank)
    stride = _canon(stride, rank)
    dilation = _canon(1 if dilation is None else dilation, rank)
    pads = canon_padding(padding, rank)
    return tuple((i + lo + hi - ((k - 1) * d + 1)) // s + 1
                 for i, k, s, d, (lo, hi) in zip(in_spatial, kernel, stride,
                                                 dilation, pads))


def insertion_sparsity(in_spatial: Ints, kernel: Ints, stride: Ints) -> float:
    """Fraction of zero activations an OOM (zero-insertion) conv reads,
    including the 'full' conv padding of K-1 at each border (Fig. 1)."""
    rank = len(in_spatial)
    kernel = _canon(kernel, rank)
    stride = _canon(stride, rank)
    nonzero = math.prod(in_spatial)
    padded = math.prod((i - 1) * s + 1 + 2 * (k - 1)
                       for i, k, s in zip(in_spatial, kernel, stride))
    return 1.0 - nonzero / padded
