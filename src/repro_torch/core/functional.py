"""Deconvolution semantics and the reference lowerings, shared by the
engine and both ops layers.

Canonical semantics (channels-last, VALID):

    y[n, o, co] = sum_{i, k : o = i*S + k*dil} x[n, i, ci] * w[k, ci, co]

with ``o``/``i``/``k`` multi-indices over the spatial rank.  The output
extent is Eq. (1) of the paper, ``O = (I - 1) * S + (K - 1) * dil + 1`` per
dim; ``padding`` then crops ``(lo, hi)`` elements from the borders.

Five methods compute it (the JAX package's names):

    oom        — the paper's baseline: zero-insert the input and run a
                 dense full convolution (the invalid MACs included);
    xla        — ``conv_transpose`` (cuDNN on the card; the only lowering
                 with ``dilation`` and ``groups``);
    iom        — the literal input-oriented mapping: every input activation
                 times the whole kernel (one ``tensordot``), overlap-added
                 into the output tap by tap;
    iom_phase  — polyphase IOM: each output phase a stride-1 full
                 correlation of the raw input with its sub-kernel;
    pallas     — the hand-written Hopper kernels (``repro_torch.kernels``).

The first four are plain tensor code, the port's counterparts of the XLA
lowerings: the reference methods the kernels are held against and the
server's fallback.  They keep the API's layouts (activations
``[N, *sp, C]``, weights ``[*K, Cin/G, Cout]``), upcast to f32 before every
library call and scope IEEE f32 (TF32 off) around it without touching
global state.
"""

from __future__ import annotations

import contextlib
import itertools
import math
from typing import Sequence

import torch
import torch.nn.functional as F

Ints = Sequence[int]

METHODS = ("oom", "xla", "iom", "iom_phase", "pallas")
PORTED_METHODS = METHODS


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


def valid_mac_fraction(stride: Ints) -> float:
    """IOM executes only the valid MACs; OOM executes 1/prod(S) valid ones."""
    return 1.0 / math.prod(stride)


def zero_insert(x: torch.Tensor, stride: Ints) -> torch.Tensor:
    """Materialise the zero-inserted ("dilated") input — the OOM substrate.

    x: [N, *I, C] -> [N, *((I-1)*S + 1), C].
    """
    rank = x.dim() - 2
    stride = _canon(stride, rank)
    if all(s == 1 for s in stride):
        return x
    out_sp = tuple((i - 1) * s + 1 for i, s in zip(x.shape[1:-1], stride))
    out = x.new_zeros((x.shape[0], *out_sp, x.shape[-1]))
    out[(slice(None),) + tuple(slice(0, None, s) for s in stride)] = x
    return out


def phase_kernels(w: torch.Tensor, stride: Ints) -> dict:
    """Split w [*K, Ci, Co] into S^d sub-kernels W_p[m] = W[m*S + p]."""
    rank = w.dim() - 2
    stride = _canon(stride, rank)
    return {p: w[tuple(slice(pj, None, sj) for pj, sj in zip(p, stride))]
            for p in itertools.product(*(range(s) for s in stride))}


# ---------------------------------------------------------------------------
# Library calls: channels-last in and out, f32, IEEE f32 scoped.
# ---------------------------------------------------------------------------

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _tf32_knobs():
    """(module, attribute, IEEE value) of the switches that choose between
    IEEE f32 and TF32 for cuDNN's convolutions and cuBLAS's matmuls: the
    ``fp32_precision`` API (reading the legacy ``allow_tf32`` flags raises
    once a caller has used it)."""
    return ((torch.backends.cudnn.conv, "fp32_precision", "ieee"),
            (torch.backends.cuda.matmul, "fp32_precision", "ieee"))


@contextlib.contextmanager
def ieee_f32():
    """IEEE f32 (TF32 off) in cuDNN and cuBLAS for the block, the previous
    settings restored after it: cuDNN's TF32 is on by default, and the
    reference contracts at IEEE f32."""
    knobs = _tf32_knobs()
    prev = [getattr(mod, attr) for mod, attr, _ in knobs]
    try:
        for mod, attr, value in knobs:
            setattr(mod, attr, value)
        yield
    finally:
        for (mod, attr, _), value in zip(knobs, prev):
            setattr(mod, attr, value)


def _f32(t: torch.Tensor) -> torch.Tensor:
    # bf16 products are exact in f32: the upcast reproduces the
    # reference's preferred_element_type=f32
    return t if t.dtype == torch.float32 else t.to(torch.float32)


def _flip_spatial(w: torch.Tensor) -> torch.Tensor:
    return torch.flip(w, dims=tuple(range(w.dim() - 2)))


def _crop(y: torch.Tensor, padding) -> torch.Tensor:
    pads = canon_padding(padding, y.dim() - 2)
    if all(lo == 0 and hi == 0 for lo, hi in pads):
        return y
    return y[(slice(None),) + tuple(
        slice(lo, dim - hi) for (lo, hi), dim in zip(pads, y.shape[1:-1]))]


class _NoSum(torch.autograd.Function):
    """f32 zeros of ``shape`` standing for a window that holds no sum: no
    element of x or w reaches them, so both gradients are zeros of their
    shapes, as the JAX package's are."""

    @staticmethod
    def forward(ctx, x, w, shape):
        ctx.like = [(t.shape, t.dtype, t.device) for t in (x, w)]
        ctx.set_materialize_grads(False)
        return torch.zeros(shape, dtype=torch.float32, device=x.device)

    @staticmethod
    def backward(ctx, dy):
        return (*(torch.zeros(sh, dtype=dt, device=dev)
                  for sh, dt, dev in ctx.like), None)


def _no_sum(x: torch.Tensor, w: torch.Tensor, out_sp: Ints):
    """``_NoSum`` of the ``[N, *out_sp, Co]`` result (extents clipped at
    0) when x or that result has no position, else None: torch's
    convolutions refuse a kernel larger than the padded input, and the
    JAX package returns an empty array there."""
    out_sp = tuple(max(int(o), 0) for o in out_sp)
    if x.numel() and math.prod(out_sp):
        return None
    return _NoSum.apply(x, w, (x.shape[0], *out_sp, w.shape[-1]))


def _deconv_no_sum(x, w, stride, padding, preferred_element_type,
                   dilation=1):
    """``_no_sum`` of a deconv's Eq. (1) extent less its crop, in
    ``preferred_element_type``."""
    y = _no_sum(x, w, deconv_output_shape(
        x.shape[1:-1], w.shape[:x.dim() - 2], stride, padding, dilation))
    return None if y is None else y.to(preferred_element_type)


def correlate(x: torch.Tensor, w: torch.Tensor, stride: Ints, padding=0, *,
              dilation: Ints | int = 1, groups: int = 1) -> torch.Tensor:
    """Channels-last strided correlation (the reference's
    ``lax.conv_general_dilated``): x [N, *I, Ci], w [*K, Ci/G, Co], f32
    out; ``padding`` per ``canon_padding`` (asymmetric pads go through
    ``F.pad``).  An extent at or below 0 gives an empty result."""
    rank = x.dim() - 2
    pads = canon_padding(padding, rank)
    empty = _no_sum(x, w, conv_output_shape(
        x.shape[1:-1], w.shape[:rank], stride, pads, dilation))
    if empty is not None:
        return empty
    xn = _f32(x).movedim(-1, 1)
    if all(lo == hi for lo, hi in pads):
        pad = tuple(lo for lo, _ in pads)
    else:
        xn = F.pad(xn, [p for pair in reversed(pads) for p in pair])
        pad = 0
    # [*K, Ci/G, Co] -> [Co, Ci/G, *K]: groups split Co group-major, as
    # lax's feature_group_count does
    wt = _f32(w).permute(rank + 1, rank, *range(rank))
    with ieee_f32():
        y = _CONV[rank](xn, wt, stride=_canon(stride, rank), padding=pad,
                        dilation=_canon(dilation, rank), groups=groups)
    return y.movedim(1, -1)


def _full_correlate(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 'full' convolution: pad K-1 both sides, flipped kernel."""
    rank = x.dim() - 2
    return correlate(x, _flip_spatial(w), (1,) * rank,
                     [(k - 1, k - 1) for k in w.shape[:rank]])


# ---------------------------------------------------------------------------
# The four reference lowerings.
# ---------------------------------------------------------------------------

def deconv_oom(x: torch.Tensor, w: torch.Tensor, stride: Ints,
               padding=0, *, preferred_element_type=torch.float32
               ) -> torch.Tensor:
    """OOM, the paper's baseline: zero-insert, then a dense convolution."""
    empty = _deconv_no_sum(x, w, stride, padding, preferred_element_type)
    if empty is not None:
        return empty
    stride = _canon(stride, x.dim() - 2)
    y = _full_correlate(zero_insert(_f32(x), stride), w)
    return _crop(y.to(preferred_element_type), padding)


def deconv_xla(x: torch.Tensor, w: torch.Tensor, stride: Ints, padding=0,
               *, dilation: Ints | int = 1, groups: int = 1,
               preferred_element_type=torch.float32) -> torch.Tensor:
    """``conv_transpose`` with kernel ``dilation`` and ``groups`` (w is
    ``[*K, Ci/G, Co]``, the lax grouping convention); the engine routes
    grouped and dilated layers of every reference method through here."""
    empty = _deconv_no_sum(x, w, stride, padding, preferred_element_type,
                           dilation)
    if empty is not None:
        return empty
    rank = x.dim() - 2
    kernel, cig, co = tuple(w.shape[:rank]), w.shape[rank], w.shape[-1]
    # [*K, Ci/G, Co] -> [Ci, Co/G, *K]: input group g feeds output
    # channels g*Co/G ... (g+1)*Co/G - 1
    wt = _f32(w).reshape(*kernel, cig, groups, co // groups).permute(
        rank + 1, rank, rank + 2, *range(rank)).reshape(
        groups * cig, co // groups, *kernel)
    with ieee_f32():
        y = _CONV_T[rank](_f32(x).movedim(-1, 1), wt,
                          stride=_canon(stride, rank),
                          dilation=_canon(dilation, rank), groups=groups)
    return _crop(y.movedim(1, -1).to(preferred_element_type), padding)


def deconv_iom(x: torch.Tensor, w: torch.Tensor, stride: Ints, padding=0,
               *, preferred_element_type=torch.float32) -> torch.Tensor:
    """IOM, the paper's Fig. 5: one matmul per input activation against
    the whole kernel, its K^d block overlap-added at o = i*S + k."""
    empty = _deconv_no_sum(x, w, stride, padding, preferred_element_type)
    if empty is not None:
        return empty
    rank = x.dim() - 2
    stride = _canon(stride, rank)
    kernel = tuple(w.shape[:rank])
    in_sp = tuple(x.shape[1:-1])
    out_sp = deconv_output_shape(in_sp, kernel, stride, 0)
    # blocks[n, *i, *k, co] = sum_ci x[n, *i, ci] w[*k, ci, co]
    with ieee_f32():
        blocks = torch.tensordot(_f32(x), _f32(w), dims=([rank + 1], [rank]))
    y = blocks.new_zeros((x.shape[0], *out_sp, w.shape[-1]))
    for k in itertools.product(*(range(kk) for kk in kernel)):
        dst = (slice(None),) + tuple(
            slice(kj, kj + sj * ij, sj)
            for kj, sj, ij in zip(k, stride, in_sp))
        y[dst] += blocks[(slice(None),) * (rank + 1) + k]
    return _crop(y.to(preferred_element_type), padding)


def deconv_iom_phase(x: torch.Tensor, w: torch.Tensor, stride: Ints,
                     padding=0, *, preferred_element_type=torch.float32
                     ) -> torch.Tensor:
    """Polyphase IOM: output phase p is a stride-1 full correlation of the
    raw input with W_p[m] = W[m*S + p], written at o = q*S + p."""
    empty = _deconv_no_sum(x, w, stride, padding, preferred_element_type)
    if empty is not None:
        return empty
    rank = x.dim() - 2
    stride = _canon(stride, rank)
    kernel = tuple(w.shape[:rank])
    out_sp = deconv_output_shape(tuple(x.shape[1:-1]), kernel, stride, 0)
    m_max = tuple(-(-k // s) for k, s in zip(kernel, stride))  # ceil(K/S)
    l_pad = tuple(i + m - 1 for i, m in zip(x.shape[1:-1], m_max))
    y = torch.zeros((x.shape[0], *(lp * s for lp, s in zip(l_pad, stride)),
                     w.shape[-1]), dtype=torch.float32, device=x.device)
    for p, wp in phase_kernels(w, stride).items():
        if any(m == 0 for m in wp.shape[:rank]):
            continue        # S > K: a phase with no taps stays zero
        yp = _full_correlate(x, wp)
        # phase p's I + M_p - 1 values; the rest up to L stay zero
        y[(slice(None),) + tuple(
            slice(pj, pj + q * sj, sj)
            for pj, sj, q in zip(p, stride, yp.shape[1:-1]))] = yp
    y = y[(slice(None),) + tuple(slice(0, o) for o in out_sp)]
    return _crop(y.to(preferred_element_type), padding)


# ---------------------------------------------------------------------------
# Uniform front-end.
# ---------------------------------------------------------------------------

# engine tuning knobs only the hand-kernel method consumes; the front ends
# split them off the call kwargs and the reference lowerings drop them
PALLAS_KNOBS = ("block_ci", "block_co", "max_tile_bytes")


def pop_pallas_knobs(kw: dict, *, method: str, op: str) -> dict:
    """Split the kernel tuning knobs out of ``kw`` (mutating it) and return
    them for ``"pallas"``, ``{}`` for a lowering; raise on any leftover
    kwarg, naming the front end and its method."""
    knobs = {k: kw.pop(k) for k in PALLAS_KNOBS if k in kw}
    if kw:
        raise ValueError(
            f"unknown {op} kwargs for method={method!r}: {sorted(kw)}; "
            f"kernel tuning knobs are {list(PALLAS_KNOBS)} (configure an "
            f"EngineConfig instead of per-call kwargs)")
    # meaningless for the lowerings: accepted and dropped
    return knobs if method == "pallas" else {}


def deconv_nd(x: torch.Tensor, w: torch.Tensor, stride: Ints, padding=0,
              method: str = "xla", *, device="cuda", **kw) -> torch.Tensor:
    """Uniform 1D/2D/3D deconvolution on the memoized default engine for
    ``method`` on ``device`` (``"cpu"`` runs the kernels' plain versions
    and the lowerings on the CPU); new code configures a ``UniformEngine``
    once and calls ``engine.deconv``.

    x: [N, *spatial, Cin], w: [*K, Cin, Cout]; ``padding`` is the border
    crop on top of the Eq. (1) extent (a scalar, per-dim scalars or
    ``(lo, hi)`` pairs).  ``kw`` takes ``preferred_element_type`` and, for
    ``"pallas"``, the kernel tuning knobs.
    """
    from repro_torch.core.engine import default_engine  # lazy: cycle
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; expected one of "
                         f"{METHODS}")
    pet = kw.pop("preferred_element_type", None)
    knobs = pop_pallas_knobs(kw, method=method, op="deconv_nd")
    engine = default_engine(method=method, preferred_element_type=pet,
                            device=device, **knobs)
    return engine.deconv(x, w, stride, padding)


def deconv_macs(in_spatial: Ints, kernel: Ints, cin: int, cout: int,
                batch: int = 1, method: str = "iom", stride: Ints = 2) -> int:
    """Executed MAC count per method (the paper's efficiency accounting)."""
    rank = len(in_spatial)
    kernel = _canon(kernel, rank)
    stride = _canon(stride, rank)
    valid = batch * math.prod(in_spatial) * math.prod(kernel) * cin * cout
    if method in ("iom", "iom_phase", "pallas"):
        return valid
    if method in ("oom", "xla"):
        # dense conv over the zero-inserted (and fully padded) input
        out_sp = deconv_output_shape(in_spatial, kernel, stride, 0)
        return batch * math.prod(out_sp) * math.prod(kernel) * cin * cout
    raise ValueError(method)
