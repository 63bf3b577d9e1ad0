"""Halo staging on the bf16 route of the forward kernels, on the CPU.

Where ``tiling.plan_halo`` allows it, a bf16 x bf16 launch of the deconv
or conv kernel runs ``csrc/igemm.cuh::igemm_bf16_halo_kernel``: a block
owns a box of the position grid and, a chunk of input channels at a time,
stages the box's whole input footprint once beside every tap's rows of
B, then reads each tap's A straight from the footprint at the row's slot
plus the tap's offset.  The kernel runs only on the card
(``chip_smoke.py``); here: which launches of the paper's models the
planner stages so and with what box; the planner's byte model against the
kernel's ``constexpr`` functions and its fit at the tile's residency; a
numpy model of the kernel's index arithmetic (box, footprint, slot table,
tap offsets, zero fill, the k16 steps of 16 or 8 channels, the store)
held against the direct gather and the plain versions, row for row and
tap for tap, and shown to catch an off-by-one; the bank groups of the
lanes' ldmatrix addresses; and the chunk-major reduction with the tensor
cores' truncating sums against the JAX package's bf16 kernel.
"""

import itertools
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.engine import EngineConfig as JaxConfig  # noqa: E402
from repro.core.engine import UniformEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import tiling  # noqa: E402
from repro_torch.core.engine import UniformEngine  # noqa: E402
from repro_torch.kernels import build, common  # noqa: E402
from repro_torch.kernels.conv import kernel as ck  # noqa: E402
from repro_torch.kernels.conv import ops as cops  # noqa: E402
from repro_torch.kernels.conv import ref as cref  # noqa: E402
from repro_torch.kernels.deconv import kernel as dk  # noqa: E402
from repro_torch.kernels.deconv import ops as dops  # noqa: E402
from repro_torch.kernels.deconv import ref as dref  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.models import dcnn  # noqa: E402

BF16 = torch.bfloat16
IGEMM = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
         / "csrc" / "igemm.cuh").read_text()
ENGINE = UniformEngine(device="cpu")
W8_TOL = 5e-5       # chip_smoke.py's f32-output gate against float64
BF16_TOL = 1e-2     # its bf16 gate (PERF.md section 2)


# -- the kernel's index arithmetic, as numpy ----------------------------------
#
# A line-by-line model of igemm_bf16_halo_kernel's addressing: box_pos,
# conv_dim / deconv_dim / HaloDim::coord, the slot and tap tables, the
# lanes' row slots, a chunk's stage, each k16 step's A and B as the
# ldmatrix reads take them, and row_of's store.  Slots the kernel never
# fills (pad) hold NaN, so a read of one shows in the sums.

class HaloDim:
    def __init__(self, org, step, s, e, f_end, dil):
        self.org, self.step, self.s, self.e = org, step, s, e
        self.f_end, self.dil = f_end, dil

    def coord(self, p):
        rho = p // self.e
        f = rho + self.s * (p - rho * self.e)
        return rho < self.s and f < self.f_end, self.org + self.step * f

    def conv_off(self, k):
        kk = k * self.dil
        return (kk % self.s) * self.e + kk // self.s


def conv_dim(o0, bx, k, s, dil, lo):
    a = math.gcd(s, dil)
    f_end = (bx - 1) * (s // a) + (k - 1) * (dil // a) + 1
    return HaloDim(o0 * s - lo, a, s // a, -(-f_end // (s // a)), f_end,
                   dil // a)


def deconv_dim(q0, bx, mlo, mhi):
    return HaloDim(q0 - mhi, 1, 1, bx + mhi - mlo, bx + mhi - mlo, 1)


def launch_geom(op, x3, wk, kw):
    """The wrapper's geometry of one launch: input extent, position grid,
    lo (crop or pad), the phases' taps (the deconv's tap table)."""
    k, s, d = kw["kernel"], kw["stride"], kw["dilation"]
    if op == "deconv":
        grid = dref.phase_rows(tuple(x3.shape[1:4]), k, s, d, kw["crop_lo"],
                               kw["out_spatial"])
        table = common.tap_table(k, s, d, "cpu").tolist()
        phases = math.prod(s)
        taps = [[tuple(table[2 * phases + 3 * (table[2 * p] + t) + j]
                       for j in range(3)) for t in range(table[2 * p + 1])]
                for p in range(phases)]
        starts = [table[2 * p] for p in range(phases)]
        lo = kw["crop_lo"]
    else:
        grid, taps, starts, lo = kw["out_spatial"], None, [0], kw["pad_lo"]
    return dict(grid=tuple(grid), kernel=k, stride=s, dil=d, lo=tuple(lo),
                groups=kw["groups"], taps=taps, starts=starts)


def halo_model(op, x, w, geom, halo, block_co, accumulate=None):
    """The sums igemm_bf16_halo_kernel stores, as [phases, N, *grid, Co]
    (float64; NaN where no block stored): x [N, D, H, W, Ci] and the
    weight slab w [taps * Cig, Co] as numpy float64.  ``accumulate(acc,
    product)`` adds a k16 step's product to the sums (default: exactly)."""
    accumulate = accumulate or (lambda acc, prod: acc + prod)
    deconv = op == "deconv"
    w = w.reshape(-1, w.shape[-1])
    n_, dd_, hh_, ww_, ci = x.shape
    co, g = w.shape[-1], geom["groups"]
    cig, cog = ci // g, co // g
    grid, (kd, kh, kwd) = geom["grid"], geom["kernel"]
    stride, dil, lo = geom["stride"], geom["dil"], geom["lo"]
    bm = tiling.BF16_KERNEL_TILES[block_co].block_m
    cc, (bd, bh, bw) = tiling.HALO_CHANNELS, halo.box
    phases = math.prod(stride) if deconv else 1
    nb = [-(-p // b) for p, b in zip(grid, halo.box)]
    out = np.full((phases, n_, *grid, co), np.nan)
    box_rows = bd * bh * bw
    r = np.arange(bm)
    rw, rh, rd = r % bw, (r // bw) % bh, r // (bw * bh)
    rslot = np.where(r < box_rows, (rd * halo.lh + rh) * halo.lw + rw, 0)
    for p in range(phases):
        ptaps = geom["taps"][p] if deconv else None
        ntaps = len(ptaps) if deconv else kd * kh * kwd
        tap0 = geom["starts"][p]
        mlo = [min((m[j] for m in ptaps), default=0) for j in range(3)] \
            if deconv else None
        mhi = [max((m[j] for m in ptaps), default=0) for j in range(3)] \
            if deconv else None
        steps = -(-ntaps // 2)           # two taps a k16 step
        chunks = cig // cc if ntaps else 0
        for grp in range(g):
            for bx in range(n_ * math.prod(nb)):
                t = bx
                ow0 = (t % nb[2]) * bw
                t //= nb[2]
                oh0 = (t % nb[1]) * bh
                t //= nb[1]
                od0 = (t % nb[0]) * bd
                n = t // nb[0]
                if deconv:
                    dims = [deconv_dim(o0, b, mlo[j], mhi[j]) for j, (o0, b)
                            in enumerate(zip((od0, oh0, ow0), halo.box))]
                else:
                    dims = [conv_dim(o0, b, k, s, dl, lw_) for o0, b, k, s,
                            dl, lw_ in zip((od0, oh0, ow0), halo.box,
                                           geom["kernel"], stride, dil, lo)]
                # the slot table: input position, zero (-1) or pad (-2),
                # from each column's w and each line's (d, h)
                colpos = []
                for pw in range(halo.lw):
                    ok, iw = dims[2].coord(pw)
                    colpos.append(-2 if not ok else iw if 0 <= iw < ww_
                                  else -1)
                slotpos = np.full(halo.slots, -1)
                for line in range((halo.slots - 1) // halo.lw):
                    pd, ph = line // halo.lh, line % halo.lh
                    (okd, id_), (okh, ih) = dims[0].coord(pd), \
                        dims[1].coord(ph)
                    inside = 0 <= id_ < dd_ and 0 <= ih < hh_
                    base = (n * dd_ + id_) * hh_ + ih
                    for pw, c in enumerate(colpos):
                        v = -2
                        if okd and okh and c != -2:
                            v = base * ww_ + c if inside and c >= 0 else -1
                        slotpos[line * halo.lw + pw] = v
                tapoff = []
                for t in range(ntaps):
                    if deconv:
                        od, oh, ow = (mhi[j] - ptaps[t][j] for j in range(3))
                    else:
                        kk = (t // (kwd * kh), (t // kwd) % kh, t % kwd)
                        od, oh, ow = (dm.conv_off(v) for dm, v in
                                      zip(dims, kk))
                    tapoff.append((od * halo.lh + oh) * halo.lw + ow)
                acc = np.zeros((bm, cog))
                xf = x.reshape(-1, ci)
                for ch in range(chunks):
                    c0 = grp * cig + ch * cc
                    stage = np.full((halo.slots, cc), np.nan)
                    stage[slotpos == -1] = 0.0
                    real = slotpos >= 0
                    stage[real] = xf[slotpos[real], c0:c0 + cc]
                    b_rows = np.zeros((steps * 16, cog))
                    for k in range(steps * 16):
                        t, c = k // cc, k % cc
                        if t < ntaps:
                            b_rows[k] = w[(tap0 + t) * cig + ch * cc + c,
                                          grp * cog:(grp + 1) * cog]
                    for ks in range(steps):
                        # lanes 0-15 (k 0-7) read tap 2 ks, lanes 16-31
                        # (k 8-15) tap 2 ks + 1 or the zero slot
                        lo_half = stage[rslot + tapoff[2 * ks]]
                        hi_half = (stage[rslot + tapoff[2 * ks + 1]]
                                   if 2 * ks + 1 < ntaps else
                                   np.repeat(stage[-1:], bm, axis=0))
                        a = np.concatenate([lo_half, hi_half], axis=1)
                        acc = accumulate(acc, a @ b_rows[ks * 16:ks * 16 + 16])
                assert not np.isnan(acc).any(), "a read of a pad slot"
                for row in range(bm):
                    od, oh, ow = od0 + rd[row], oh0 + rh[row], ow0 + rw[row]
                    if (row >= box_rows or od >= grid[0] or oh >= grid[1]
                            or ow >= grid[2]):
                        continue
                    dst = out[p, n, od, oh, ow, grp * cog:(grp + 1) * cog]
                    assert np.isnan(dst).all(), "a row stored twice"
                    dst[:] = acc[row]
    return out


def gather_model(op, x, w, geom):
    """The same sums by the direct gather: row q of phase p reads x[q - m]
    for each tap m (the deconv), or row o reads x[o S + k dil - lo] (the
    conv); zero outside x."""
    deconv = op == "deconv"
    w = w.reshape(-1, w.shape[-1])
    n_, *ext, ci = x.shape
    co, g = w.shape[-1], geom["groups"]
    cig, cog = ci // g, co // g
    grid = geom["grid"]
    phases = math.prod(geom["stride"]) if deconv else 1
    out = np.zeros((phases, n_, *grid, co))
    pos = np.stack(np.meshgrid(*(np.arange(v) for v in grid),
                               indexing="ij"), -1)
    for p in range(phases):
        if deconv:
            offs = [tuple(-m for m in tap) for tap in geom["taps"][p]]
            base = pos
        else:
            kd, kh, kwd = geom["kernel"]
            offs = [tuple(k * dl for k, dl in zip((a, b, c), geom["dil"]))
                    for a in range(kd) for b in range(kh) for c in range(kwd)]
            base = pos * np.array(geom["stride"]) - np.array(geom["lo"])
        for t, off in enumerate(offs):
            src = base + np.array(off)
            ok = ((src >= 0) & (src < np.array(ext))).all(-1)
            idx = np.where(ok[..., None], src, 0)
            a = x[:, idx[..., 0], idx[..., 1], idx[..., 2]]
            a = np.where(ok[None, ..., None], a, 0.0)
            row0 = (geom["starts"][p] + t) * cig
            for grp in range(g):
                out[p, ..., grp * cog:(grp + 1) * cog] += (
                    a[..., grp * cig:(grp + 1) * cig]
                    @ w[row0:row0 + cig, grp * cog:(grp + 1) * cog])
    return out


def scatter_phases(op, sums, geom, out_spatial):
    """The per-phase sums stored as the kernel's epilogue stores them
    (out_offset): the deconv's q S + p - lo inside the cropped output."""
    if op == "conv":
        return sums[0]
    s, lo = geom["stride"], geom["lo"]
    n, co = sums.shape[1], sums.shape[-1]
    y = np.full((n, *out_spatial, co), np.nan)
    for p, ph in enumerate(np.ndindex(*s)):
        for q in np.ndindex(*geom["grid"]):
            o = [qi * si + pi - li for qi, si, pi, li in zip(q, s, ph, lo)]
            if all(0 <= v < e for v, e in zip(o, out_spatial)):
                y[:, o[0], o[1], o[2]] = sums[p][:, q[0], q[1], q[2]]
    return y


def small_ints(rng, shape):
    """Values exact in bf16 whose float64 sums are exact."""
    return rng.integers(-8, 9, size=shape) / 4.0


def case_args(op, in_spatial, cin, w_shape, stride, padding, dilation=1,
              groups=1, batch=2, seed=0):
    """(x3, w slab, kernel kwargs) of a case, through the ops' own
    argument functions, as exact small values."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(small_ints(rng, (batch, *in_spatial, cin)))
    w = torch.from_numpy(small_ints(rng, w_shape))
    args = (dops.deconv_kernel_args if op == "deconv"
            else cops.conv_kernel_args)
    x3, wk, kw, _ = args(x, w, stride, padding, dilation=dilation,
                         groups=groups, engine=ENGINE)
    return x3, wk, kw


# (tag, op, in_spatial, cin, w_shape, stride, padding, dilation, groups)
MODEL_CASES = [
    ("deconv:k3s2:taps1-8", "deconv", (5, 6, 7), 16, (3, 3, 3, 16, 16), 2,
     ((0, 1),) * 3, 1, 1),
    ("deconv:k4s2:pad1", "deconv", (4, 5, 3), 16, (4, 4, 4, 16, 16), 2, 1,
     1, 1),
    ("deconv:k3s2:dil2:empty-phases", "deconv", (4, 5, 6), 16,
     (3, 3, 3, 16, 16), 2, 1, 2, 1),
    ("conv:k3s2:pad1", "conv", (11, 9, 13), 16, (3, 3, 3, 16, 32), 2, 1, 1,
     1),
    ("conv:k4s2:pad1", "conv", (10, 8, 12), 16, (4, 4, 4, 16, 16), 2, 1, 1,
     1),
    ("conv:k3s1:dil2", "conv", (9, 10, 8), 16, (3, 3, 3, 16, 16), 1, 2, 2,
     1),
    ("conv:k3s2:dil2", "conv", (12, 11, 10), 16, (3, 3, 3, 16, 16), 2, 2,
     2, 1),
    ("conv:groups2:cig8", "conv", (7, 9, 8), 16, (3, 3, 3, 8, 32), 1, 1, 1,
     2),
    ("deconv:groups2:cig8", "deconv", (4, 5, 6), 16, (3, 3, 3, 8, 16), 2,
     ((0, 1),) * 3, 1, 2),
    ("conv2d:k3s1", "conv", (17, 23), 16, (3, 3, 16, 16), 1, 1, 1, 1),
    ("deconv2d:k3s2", "deconv", (7, 9), 32, (3, 3, 32, 16), 2,
     ((0, 1),) * 2, 1, 1),
]


def _model_check(op, x3, wk, kw, halo, accumulate=None):
    geom = launch_geom(op, x3, wk, kw)
    x, w = x3.numpy(), wk.numpy()
    got = halo_model(op, x, w, geom, halo, kw["block_co"], accumulate)
    want = gather_model(op, x, w, geom)
    return got, want, geom


def _boxes_for(op, x3, kw):
    """Boxes besides the planner's: ragged at every edge, and another."""
    grid = launch_geom(op, x3, None, kw)["grid"]
    ragged = tuple(max(1, min(p - 1, b)) if p > 1 else 1
                   for p, b in zip(grid, (3, 4, 5)))
    other = tuple(min(p, b) for p, b in zip(grid, (2, 3, 8)))
    out = []
    for box in sorted({ragged, other}):
        halo = tiling.halo_for_box(op, box, kw["kernel"], kw["stride"],
                                   kw["dilation"], kw["block_co"], grid)
        if halo is not None:
            out.append(halo)
    return out


@pytest.mark.parametrize("case", MODEL_CASES, ids=[c[0] for c in MODEL_CASES])
def test_index_model_is_the_direct_gather(case):
    """Every row of every box, every tap and chunk: the model of the
    kernel's addressing sums exactly what the direct gather sums (small
    integers / 4, exact in bf16 and in float64), and, stored as the
    epilogue stores them, what the plain version computes.  Boxes: the
    planner's (forced unsplit, as the halo launches are) and ragged ones
    whose edges cut every dim (the planner may keep a case on the
    gather: its cost model, not the arithmetic, decides)."""
    tag, op, sp, cin, ws, st, pad, dil, g = case
    x3, wk, kw = case_args(op, sp, cin, ws, st, pad, dil, g)
    geom = launch_geom(op, x3, wk, kw)
    plan = tiling.plan_uniform_tiles(cin, ws[-1], mode=op,
                                     block_co=kw["block_co"], groups=g,
                                     in_dtype_bytes=2, w_dtype_bytes=2)
    planned = tiling.plan_halo(plan, op, geom["grid"], kw["kernel"],
                               kw["stride"], kw["dilation"], cin // g, 1,
                               x3.shape[0])
    halos = [planned] * (planned is not None) + _boxes_for(op, x3, kw)
    assert len(halos) >= 2, tag
    plain = (dref.deconv_fwd_plain if op == "deconv"
             else cref.conv_fwd_plain)
    kwp = {k: v for k, v in kw.items() if k not in ("block_co", "split")}
    ref = plain(x3, wk, **dict(kwp, out_dtype=torch.float64)).numpy()
    for halo in halos:
        got, want, geom = _model_check(op, x3, wk, kw, halo)
        assert not np.isnan(got).any(), (tag, halo)
        np.testing.assert_array_equal(got, want, err_msg=f"{tag} {halo}")
        y = scatter_phases(op, got, geom, kw["out_spatial"])
        np.testing.assert_array_equal(y, ref, err_msg=f"{tag} {halo}")


def test_index_model_catches_a_slip():
    """The model is sensitive: a footprint origin one position off (the
    deconv's q0 - mhi + 1, the conv's residue length one short) changes
    the sums or reads a slot the kernel never fills."""
    global deconv_dim, conv_dim
    cases = {c[0]: c for c in MODEL_CASES}
    real = deconv_dim, conv_dim
    slips = {
        "deconv:k3s2:taps1-8": lambda: globals().__setitem__(
            "deconv_dim", lambda q0, bx, lo, hi: HaloDim(
                q0 - hi + 1, 1, 1, bx + hi - lo, bx + hi - lo, 1)),
        "conv:k3s2:pad1": lambda: globals().__setitem__(
            "conv_dim", lambda o0, bx, k, s, d, lo: HaloDim(
                o0 * s - lo, 1, s, -(-((bx - 1) * s + (k - 1) * d) // s),
                (bx - 1) * s + (k - 1) * d, d)),
    }
    for tag, slip in slips.items():
        _, op, sp, cin, ws, st, pad, dil, g = cases[tag]
        x3, wk, kw = case_args(op, sp, cin, ws, st, pad, dil, g)
        geom = launch_geom(op, x3, wk, kw)
        halo = tiling.halo_for_box(op, (2, 3, 4), kw["kernel"],
                                   kw["stride"], kw["dilation"],
                                   kw["block_co"], geom["grid"])
        got, want, _ = _model_check(op, x3, wk, kw, halo)
        np.testing.assert_array_equal(got, want)
        slip()
        try:
            try:
                bad, want, _ = _model_check(op, x3, wk, kw, halo)
                caught = not np.array_equal(bad, want)
            except AssertionError:       # a pad slot read, a row twice
                caught = True
        finally:
            deconv_dim, conv_dim = real
        assert caught, tag


# -- the paper's models: which launches the planner stages so -----------------

def _model_layers():
    """(model, layer, batch) of every forward geometry the main paths run
    in bf16: DCGAN's generator and discriminator at 64, V-Net at 4, the
    GP-GAN and 3D-GAN generators at 4 and 3D-GAN's train graphs at 32."""
    out = []
    for arch in ("dcgan", "v-net", "3d_gan"):
        cfg = get_config(arch)
        for name, graph in ST.train_graphs(cfg).items():
            out += [(f"{arch}.{name}", l, cfg.dcnn_batch)
                    for l in graph.layers]
    for arch in ("gp_gan", "3d_gan"):
        out += [(f"{arch}.gen", l, 4)
                for l in dcnn._generator_graph(arch, False).layers]
    return [o for o in out if not o[1].empty]


def _launches(layer, batch):
    """(which, op, x3, w, kwargs) of a layer's forward and dx launches,
    on meta tensors."""
    meta = dict(device="meta", dtype=BF16)
    x = torch.empty((batch, *layer.in_spatial, layer.cin), **meta)
    w = torch.empty(layer.weight_shape, **meta)
    dy = torch.empty((batch, *layer.out_spatial, layer.cout), **meta)
    fwd = (dops.deconv_kernel_args if layer.op == "deconv"
           else cops.conv_kernel_args)
    x3, wk, kw, _ = fwd(x, w, layer.stride, layer.padding,
                        dilation=layer.dilation, groups=layer.groups,
                        engine=ENGINE)
    back = (dops.deconv_backward_args if layer.op == "deconv"
            else cops.conv_backward_args)
    (a, b, dkw), _ = back(x, w, dy, layer.stride, layer.padding,
                          dilation=layer.dilation, groups=layer.groups,
                          engine=ENGINE, dw=False)
    dx_op = "conv" if layer.op == "deconv" else "deconv"
    return [("fwd", layer.op, x3, wk, kw), ("dx", dx_op, a, b, dkw)]


def _planned(op, x3, w, kw):
    return (dk.planned_halo if op == "deconv" else ck.planned_halo)(
        x3, w, **kw)


def _wrapper_split(op, x3, w, kw):
    """The slices the wrapper's launch takes (``tiling.launch_split``)."""
    if op == "deconv":
        return dk._launch_plan(x3, w, w.shape[-1], kw["kernel"],
                               kw["stride"], kw["dilation"], kw["groups"],
                               kw["crop_lo"], kw["out_spatial"],
                               kw["block_co"], kw.get("split", "auto"), "bf16")[1]
    return ck._launch_plan(x3, w, w.shape[-1], kw["kernel"], kw["stride"],
                           kw["dilation"], kw["groups"], kw["out_spatial"],
                           kw["block_co"], kw.get("split", "auto"), "bf16")[0]


MODEL_LAYERS = _model_layers()


@pytest.mark.parametrize("model,layer,batch", MODEL_LAYERS,
                         ids=[f"{m}:{l.name}:b{b}" for m, l, b in
                              MODEL_LAYERS])
def test_planner_eligibility_of_every_model_launch(model, layer, batch):
    """Each bf16 forward and dx launch: no halo for Cin/G not a multiple
    of 8, one tap, a split launch; where the planner stages a halo, its
    box lies in the grid within the tile's rows, its chunk divides Cin/G,
    its footprint, pitches, slots and steps are the kernel's count, the
    lanes' rows pass the bank-group check, and two stages fit at the
    tile's residency."""
    for which, op, x3, w, kw in _launches(layer, batch):
        halo = _planned(op, x3, w, kw)
        geom = launch_geom(op, x3, None, kw)
        cig = x3.shape[-1] // kw["groups"]
        taps = tiling.halo_taps(op, kw["kernel"], kw["stride"],
                                kw["dilation"])
        splits = _wrapper_split(op, x3, w, kw)
        tag = f"{model}:{layer.name}:{which}"
        if cig % tiling.HALO_CHANNELS or taps <= 1 or splits > 1:
            assert halo is None, tag
            continue
        if halo is None:
            continue       # no footprint fits the tile's residency
        tile = tiling.BF16_KERNEL_TILES[kw["block_co"]]
        assert math.prod(halo.box) <= tile.block_m, tag
        assert all(1 <= b <= p for b, p in zip(halo.box, geom["grid"])), tag
        assert halo.extent == tiling.halo_extent(
            op, halo.box, kw["kernel"], kw["stride"], kw["dilation"]), tag
        assert halo.lh >= halo.extent[1] and halo.lw >= halo.extent[2]
        assert halo.slots == halo.extent[0] * halo.lh * halo.lw + 1, tag
        assert halo.steps == -(-taps // 2), tag
        assert tiling.halo_banks_ok(halo.box, halo.lh, halo.lw,
                                    tile.block_m), tag
        assert tiling.halo_fits(halo, kw["block_co"]), tag
        assert tile.min_blocks * (halo.smem_bytes
                                  + tiling.SMEM_RESERVED_PER_BLOCK) \
            <= tiling.SMEM_PER_SM
        assert halo.fields() == (*halo.box, halo.lh, halo.lw, halo.slots,
                                 halo.steps)
        assert len(halo.fields()) == tiling.HALO_FIELDS
        bm, n = tile.block_m, x3.shape[0]
        assert tiling.halo_cost(halo, op, kw["kernel"], kw["stride"], cig,
                                bm, n) < tiling.HALO_GAIN * \
            tiling.gather_cost(geom["grid"], kw["kernel"], cig, bm, n), tag


def test_planner_stages_the_named_layers_and_keeps_the_rest():
    """The layers the route is measured on: V-Net's merge2-4 forward and
    the stride-1 deconvs of its convs' dx stage a halo (merge4 in boxes
    of 4 x 8 x 8); its stride-2 up deconvs (at most 8 of 27 taps a
    phase) and encoder convs (a footprint of 8 input positions a row)
    model under the gather's cost and keep it, as do 3D-GAN's deconv3
    (stride 2), V-Net's enc1 (1 channel) and head (one tap), DCGAN's
    discriminator conv1 (3 channels), the split launches (V-Net's merge1,
    enc4 and enc5 at batch 4) and grids too small to fill a box's rows."""
    staged = {}
    for model, layer, batch in MODEL_LAYERS:
        for which, op, x3, w, kw in _launches(layer, batch):
            staged[(model, layer.name, which)] = _planned(op, x3, w, kw)
    for name, which in (("merge2", "fwd"), ("merge3", "fwd"),
                        ("merge4", "fwd"), ("merge4", "dx"),
                        ("enc1", "dx")):
        assert staged[("v-net.vnet", f"vnet.{name}", which)] is not None, \
            name
    assert staged[("v-net.vnet", "vnet.merge4", "fwd")].box == (4, 8, 8)
    for name in ("merge1", "enc4", "enc5", "enc2", "enc3", "up1", "up2",
                 "up3", "up4"):
        assert staged[("v-net.vnet", f"vnet.{name}", "fwd")] is None, name
    assert staged[("v-net.vnet", "vnet.enc1", "fwd")] is None
    assert staged[("v-net.vnet", "vnet.head", "fwd")] is None
    assert staged[("v-net.vnet", "vnet.head", "dx")] is None
    gan3d = [v for (m, n, wh), v in staged.items()
             if m == "3d_gan.gen" and n.endswith("deconv3") and wh == "fwd"]
    assert gan3d and all(v is None for v in gan3d)
    disc1 = [v for (m, n, wh), v in staged.items()
             if m == "dcgan.disc" and wh == "fwd" and n.endswith("1")]
    assert disc1 and all(v is None for v in disc1)
    # DCGAN's deconv1 at batch 64: 25 positions a phase, one box of 128
    # rows an item, where the gather packs 12.5 row tiles for the batch
    assert staged[("dcgan.gen", "dcgan.deconv1", "fwd")] is None
    # the whole set: V-Net's stride-1 merge convs and the stride-1 deconvs
    # of its convs' dx (merge1's forward splits, merge3's dx models too
    # close to the gather); nothing of the GANs at these shapes
    assert {k for k, v in staged.items() if v is not None} == {
        ("v-net.vnet", f"vnet.{name}", which) for name, which in (
            ("merge2", "fwd"), ("merge3", "fwd"), ("merge4", "fwd"),
            ("enc1", "dx"), ("merge1", "dx"), ("merge2", "dx"),
            ("merge4", "dx"))}


def test_only_bf16_pairs_with_aligned_x_stage_a_halo():
    """The planner stages halos for bf16 x bf16 alone; the wrappers ask it
    only where x takes 16-byte copies (Cin/G a multiple of 8, x 16-byte
    aligned), so f32, int8 and a misaligned view keep their kernels."""
    kw = dict(kernel=(3, 3, 3), stride=(1, 1, 1), dilation=(1, 1, 1),
              groups=1, out_spatial=(32, 32, 32), block_co=16)
    plan = tiling.plan_uniform_tiles(32, 16, mode="conv", in_dtype_bytes=2,
                                     w_dtype_bytes=2)
    grid = (8, 8, 8)
    assert tiling.plan_halo(plan, "conv", grid, (3, 3, 3), (1, 1, 1),
                            (1, 1, 1), 32, 1, 4) is not None
    for xb, wb in ((4, 4), (4, 1), (2, 1), (1, 1)):
        assert tiling.plan_halo(plan, "conv", grid, (3, 3, 3), (1, 1, 1),
                                (1, 1, 1), 32, 1, 4, in_dtype_bytes=xb,
                                w_dtype_bytes=wb) is None
    shape = (4, 34, 34, 34, 32)       # unsplit: 512 blocks of 256 rows
    x = torch.zeros(shape, dtype=BF16)
    w = torch.zeros(27, 32, 16, dtype=BF16)
    assert ck.planned_halo(x, w, **kw) is not None
    assert ck.planned_halo(x.float(), w.float(), **kw) is None
    shifted = torch.zeros(1 + math.prod(shape), dtype=BF16)[1:].view(shape)
    assert shifted.data_ptr() % 16
    assert ck.planned_halo(shifted, w, **kw) is None
    # split launches and one-tap layers keep the gather
    assert tiling.plan_halo(plan, "conv", grid, (3, 3, 3), (1, 1, 1),
                            (1, 1, 1), 32, 2, 4) is None
    assert tiling.plan_halo(plan, "conv", grid, (1, 1, 1), (1, 1, 1),
                            (1, 1, 1), 32, 1, 4) is None
    assert tiling.plan_halo(plan, "conv", grid, (3, 3, 3), (1, 1, 1),
                            (1, 1, 1), 12, 1, 4) is None
    # a grid too small for a box's rows: DCGAN's 5 x 5 phase grid at
    # batch 64 packs 12.5 row tiles on the gather, 64 boxes on a halo
    dplan = tiling.plan_uniform_tiles(1024, 512, in_dtype_bytes=2,
                                      w_dtype_bytes=2)
    assert tiling.plan_halo(dplan, "deconv", (5, 1, 5), (3, 1, 3),
                            (2, 1, 2), (1, 1, 1), 1024, 1, 64) is None


# -- the byte model against the kernel's constexpr ----------------------------

def _cpp_function(name):
    body = re.search(name + r"\(int slots, int steps[^)]*\) \{(.*?)\n\}",
                     IGEMM, re.S)
    assert body, name
    return body.group(1)


def _eval_cpp(expr, env):
    """A C++ integer expression of the byte model, in Python."""
    py = expr.replace("TL::BM", "BM").replace("TL::CPITCH", "CPITCH")
    py = re.sub(r"halo_stage_bytes<TL>\(slots, steps\)",
                "stage(slots, steps)", py)
    py = py.replace("bf16_b_pitch<TL::BN>()", "BP")
    py = re.sub(r"(\w+) > (\w+) \? (\w+) : (\w+)",
                r"(\3 if \1 > \2 else \4)", py)
    return eval("(" + py + ")", {}, env)


def _cpp_constant(name):
    return int(re.search(r"constexpr int " + name + r" = (\d+);",
                         IGEMM).group(1))


@pytest.mark.parametrize("block_co", sorted(tiling.BF16_KERNEL_TILES))
def test_halo_byte_model_mirrors_the_kernel_source(block_co):
    """``tiling.halo_smem_bytes`` is igemm.cuh's ``halo_stage_bytes`` /
    ``halo_smem_bytes``, parsed from the source and evaluated over slots
    and steps, at the stages, channels, slot pitch and table sizes the
    source declares; a slot's 16 bytes are 8 bf16 channels, whose eight
    consecutive slots fill the eight bank groups."""
    for name in ("HALO_STAGES", "HALO_CHANNELS", "HALO_PITCH", "HALO_FIELDS",
                 "MAX_TAPS"):
        assert _cpp_constant(name) == getattr(tiling, name), name
    assert tiling.HALO_PITCH == 2 * tiling.HALO_CHANNELS == 16
    tile = tiling.BF16_KERNEL_TILES[block_co]
    stage_src = _cpp_function("halo_stage_bytes")
    smem_src = _cpp_function("halo_smem_bytes")
    for slots, steps in itertools.product((2, 97, 601, 2177),
                                          (1, 4, 14, 27)):
        env = dict(slots=slots, steps=steps, HALO_PITCH=tiling.HALO_PITCH,
                   HALO_STAGES=tiling.HALO_STAGES,
                   BP=tiling.bf16_b_pitch(block_co), BM=tile.block_m,
                   CPITCH=block_co + 4, MAX_TAPS=tiling.MAX_TAPS)
        env["stage"] = lambda sl, st, e=env: _eval_cpp(
            stage_src.split("return")[1].strip().rstrip(";"),
            dict(e, slots=sl, steps=st))
        ring = _eval_cpp(smem_src.split("const int ring =")[1].split(
            ";")[0], env)
        env.update(ring=ring, ctile=tile.block_m * (block_co + 4) * 4)
        want = _eval_cpp(smem_src.split("return")[1].strip().rstrip(";"),
                         env)
        assert tiling.halo_smem_bytes(tile.block_m, block_co, slots,
                                      steps) == want


@pytest.mark.parametrize("model,layer,batch", MODEL_LAYERS[::3],
                         ids=[f"{m}:{l.name}:b{b}" for m, l, b in
                              MODEL_LAYERS[::3]])
def test_step_byte_model_takes_the_halo_term(model, layer, batch):
    """``step_byte_model``'s bytes of a halo-staged launch are the halo
    block's (the planner's fit reads them), and its bytes of the gather
    are unchanged."""
    step = tiling.step_byte_model(in_dtype_bytes=2, w_dtype_bytes=2)
    for _, op, x3, w, kw in _launches(layer, batch):
        halo = _planned(op, x3, w, kw)
        tile = tiling.BF16_KERNEL_TILES[kw["block_co"]]
        gather = step(tile.block_m, 32, kw["block_co"], tile.stages)
        assert gather == tiling.plan_uniform_tiles(
            x3.shape[-1], w.shape[-1], mode=op, block_co=kw["block_co"],
            groups=kw["groups"], in_dtype_bytes=2,
            w_dtype_bytes=2).step_smem_bytes
        if halo is not None:
            assert step(tile.block_m, 32, kw["block_co"], tile.stages,
                        halo=halo) == halo.smem_bytes


# -- bank groups of the lanes' ldmatrix addresses ----------------------------

def _lane_addresses(halo, block_co, off_lo, off_hi, pitch=None):
    """Every warp's and fragment's ldmatrix row addresses of one k16 step
    (bytes from the stage), as the kernel's lanes compute them: lanes 0-15
    at rows r of the step's first tap, lanes 16-31 the same rows of its
    second."""
    tile = tiling.BF16_KERNEL_TILES[block_co]
    hp = pitch or tiling.HALO_PITCH
    rslot = tiling.halo_row_slots(halo.box, halo.lh, halo.lw, tile.block_m)
    out = []
    for wm in range(tile.warps_m):
        for i in range(tile.block_m // tile.warps_m // 16):
            lanes = []
            for lane in range(32):
                r = wm * (tile.block_m // tile.warps_m) + i * 16 + lane % 16
                off = off_lo if lane < 16 else off_hi
                lanes.append((rslot[r] + off) * hp)
            out.append(lanes)
    return out


def _worst_conflict(addresses, rows_ok):
    worst = 1
    for lanes in addresses:
        for q in range(4):
            mat = [lanes[lane] for lane in range(8 * q, 8 * q + 8)
                   if rows_ok(lane)]
            banks = [(a // 16) % 8 for a in mat]
            if not banks:
                continue
            worst = max(worst, max(banks.count(b) for b in set(banks)))
    return worst


@pytest.mark.parametrize("model,layer,batch", MODEL_LAYERS,
                         ids=[f"{m}:{l.name}:b{b}" for m, l, b in
                              MODEL_LAYERS])
def test_halo_pitch_puts_each_matrix_on_eight_bank_groups(model, layer,
                                                          batch):
    """For every planned halo of the models' launches, every tap (and at
    8 channels every pair of taps a step reads): the eight rows of each
    8 x 16-byte ldmatrix matrix start in eight distinct 16-byte bank
    groups (the box's rows fill whole matrices: the planner's boxes take
    a multiple of 8 rows or rows past them read slot 0, whose conflicts
    the check leaves out)."""
    for _, op, x3, w, kw in _launches(layer, batch):
        halo = _planned(op, x3, w, kw)
        if halo is None:
            continue
        rows = math.prod(halo.box)
        offs = sorted({(od * halo.lh + oh) * halo.lw + ow
                       for od in range(halo.extent[0] - halo.box[0] + 1)
                       for oh in range(halo.extent[1] - halo.box[1] + 1)
                       for ow in range(halo.extent[2] - halo.box[2] + 1)})
        for off in offs[:4] + offs[-4:]:
            addrs = _lane_addresses(halo, kw["block_co"], off, offs[0])
            tile = tiling.BF16_KERNEL_TILES[kw["block_co"]]
            per_warp = tile.block_m // tile.warps_m
            for n_, lanes in enumerate(addrs):
                base = (n_ // (per_warp // 16)) * per_warp \
                    + (n_ % (per_warp // 16)) * 16
                ok = [base + lane % 16 < rows for lane in range(32)]
                assert _worst_conflict([lanes], lambda lane: ok[lane]) == 1


def test_an_even_pitch_conflicts_two_ways():
    """At 32 bytes a slot (16 channels a slot, unpadded) neighbouring
    positions of a box line would conflict two ways; at the kernel's 16
    bytes (8 channels) they do not."""
    halo = tiling.halo_for_box("conv", (4, 8, 8), (3, 3, 3), (1, 1, 1),
                               (1, 1, 1), 16, (64, 64, 64))
    good = _lane_addresses(halo, 16, 0, 0)
    bad = _lane_addresses(halo, 16, 0, 0, pitch=32)
    assert _worst_conflict(good, lambda lane: True) == 1
    assert _worst_conflict(bad, lambda lane: True) == 2


def test_unpadded_lines_would_conflict_where_the_planner_pads():
    """A box 4 positions wide spans two lines per matrix: at the
    footprint's own line length (6, a 3x3x3 conv) two rows of a matrix
    share a bank group, and the planner pads the lines to 12."""
    box, extent = (8, 8, 4), tiling.halo_extent("conv", (8, 8, 4),
                                                (3, 3, 3), (1, 1, 1),
                                                (1, 1, 1))
    assert extent == (10, 10, 6)
    assert not tiling.halo_banks_ok(box, 10, 6, 256)
    halo = tiling.halo_for_box("conv", box, (3, 3, 3), (1, 1, 1),
                               (1, 1, 1), 16)
    assert halo.lw == 12 and tiling.halo_banks_ok(box, halo.lh, halo.lw,
                                                  256)


# -- the chunk-major reduction against float64 and the JAX package ------------

def _rz_f32(v):
    """float64 ``v`` rounded to f32 toward zero (the tensor cores' adder,
    its worst case)."""
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f.astype(np.float64)


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16).double(
    ).numpy()


def test_chunk_major_sums_stay_under_the_f32_gate():
    """V-Net merge4's reduction (27 taps x 32 channels, 8 a chunk: four
    chunks of 14 k16 steps, the last of each half zero), summed as the
    halo kernel sums it, each step truncated: within chip_smoke.py's
    5e-5 of max |y| of float64, as the gather's order is."""
    rng = np.random.default_rng(4)
    x3, wk, kw = case_args("conv", (8, 9, 10), 32, (3, 3, 3, 32, 16), 1, 1,
                           batch=1)
    x = _bf16(rng.normal(size=x3.shape))
    w = _bf16(rng.normal(size=wk.shape) / np.sqrt(864))
    geom = launch_geom("conv", x3, wk, kw)
    halo = tiling.halo_for_box("conv", (4, 8, 8), kw["kernel"],
                               kw["stride"], kw["dilation"], 16,
                               geom["grid"])
    got = halo_model("conv", x, w, geom, halo, 16,
                     lambda acc, prod: _rz_f32(acc + prod))
    exact = gather_model("conv", x, w, geom)
    rel = np.abs(got - exact).max() / np.abs(exact).max()
    assert 0 < rel < W8_TOL / 2


@pytest.mark.parametrize("op", ["conv", "deconv"])
def test_chunk_major_sums_match_the_jax_bf16_kernel(op):
    """A 3x3x3 layer in bf16 (the conv stride 1, the deconv stride 2, 8
    and 16 channels a chunk): the halo kernel's chunk-major sums, each
    k16 step truncated, rounded to the bf16 output, agree with the JAX
    package's bf16 kernel (interpret mode; bf16 operands, f32 sums)
    within chip_smoke.py's bf16 gate, 1e-2 of max |y|."""
    rng = np.random.default_rng(11)
    sp, cin, cout = ((6, 5, 7), 32, 16) if op == "conv" else ((3, 4, 3), 16,
                                                               16)
    x = rng.normal(size=(1, *sp, cin)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, cin, cout)) / np.sqrt(27 * cin)).astype(
        np.float32)
    stride, pad = (1, 1) if op == "conv" else (2, ((0, 1),) * 3)
    jeng = JaxEngine(JaxConfig(method="pallas"))
    fn = jeng.conv if op == "conv" else jeng.deconv
    ref = np.asarray(fn(jnp.asarray(x, jnp.bfloat16),
                        jnp.asarray(w, jnp.bfloat16), stride, pad)
                     ).astype(np.float32)
    args = (cops.conv_kernel_args if op == "conv"
            else dops.deconv_kernel_args)
    x3, wk, kw, shape = args(torch.from_numpy(x).to(BF16),
                             torch.from_numpy(w).to(BF16), stride, pad,
                             engine=ENGINE)
    geom = launch_geom(op, x3, wk, kw)
    for box in ((2, 3, 4), (3, 5, 8)):
        halo = tiling.halo_for_box(op, box, kw["kernel"], kw["stride"],
                                   kw["dilation"], kw["block_co"],
                                   geom["grid"])
        sums = halo_model(op, x3.double().numpy(), wk.double().numpy(),
                          geom, halo, kw["block_co"],
                          lambda acc, prod: _rz_f32(acc + prod))
        y = scatter_phases(op, sums, geom, kw["out_spatial"])
        got = _bf16(y).reshape(ref.shape)
        assert np.abs(got - ref).max() <= BF16_TOL * np.abs(ref).max()
