"""The TMA + wgmma staging of kernel 1's bf16 stride-2 deconvs, on the CPU.

Where ``tiling.plan_wgmma`` allows it (bf16 x bf16, more than one phase,
Cin/G a multiple of 64, Cout/G of 16, unsplit, 16-byte aligned), a deconv
launch runs ``csrc/deconv_wgmma.cu::igemm_bf16_wgmma_kernel`` over each
phase's cropped grid: a tile is one phase x one TMA box of 128 positions
x a channel tile, a stage one tap x 64 input channels.  The kernel runs
only on the card (``chip_smoke.py``'s "wgmma route" phase,
``tests/test_torch_wgmma_card.py``); here: which launches of the paper's
models the planner gives it; a numpy model of the kernel's tiling (work
units, tiles, TMA boxes zero-filled outside x, rows to outputs) held
against the direct gather and the plain version, every kept output
written once, and shown to catch a slip; the plan's layout and shared
memory against the source's ``constexpr``s; and the wrapper's records:
the staging the entry reports against the planner's, and the counter.
"""

import dataclasses
import itertools
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import tiling  # noqa: E402
from repro_torch.core.engine import UniformEngine  # noqa: E402
from repro_torch.kernels import build, common  # noqa: E402
from repro_torch.kernels.conv import ops as cops  # noqa: E402
from repro_torch.kernels.deconv import kernel as dk  # noqa: E402
from repro_torch.kernels.deconv import ops as dops  # noqa: E402
from repro_torch.kernels.deconv import ref as dref  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.models import dcnn  # noqa: E402

BF16 = torch.bfloat16
SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "csrc" / "deconv_wgmma.cu").read_text()
ENGINE = UniformEngine(device="cpu")


# -- the kernel's tiling, as numpy ---------------------------------------------
#
# A line-by-line model of igemm_bf16_wgmma_kernel's work: wg_tile's decode
# of (unit, k) into phase, channel tile and box; each stage's A box from the
# TMA (origin minus the tap's offset, zero outside x) and B boxes; the
# 128 x BN sums; the epilogue's rows to outputs, masked by the crop.

def tma_box(x, origin, shape):
    """The TMA's box of ``shape`` at ``origin`` (any coordinates, negative
    too) of the array ``x``: the overlap copied, zeros elsewhere."""
    out = np.zeros(shape, x.dtype)
    src, dst = [], []
    for o, s, e in zip(origin, shape, x.shape):
        a, b = max(o, 0), min(o + s, e)
        if a >= b:
            return out
        src.append(slice(a, b))
        dst.append(slice(a - o, b - o))
    out[tuple(dst)] = x[tuple(src)]
    return out


def plan_taps(kernel, stride, dilation):
    """The tap table as the kernel reads it: (tap0, ntaps) per phase and
    (m_d, m_h, m_w) per tap."""
    table = common.tap_table(kernel, stride, dilation, "cpu").tolist()
    phases = math.prod(stride)
    heads = [(table[2 * p], table[2 * p + 1]) for p in range(phases)]
    offs = table[2 * phases:]
    return heads, [tuple(offs[3 * t:3 * t + 3]) for t in range(len(offs) // 3)]


def tiles_of(plan, n, groups, cog):
    """Every (unit, k, tile) the launch runs, in the kernel's decode:
    tile = (phase, group, co0, n0, qd0, qh0, qw0)."""
    bn, bd, bh, bw = plan.box
    bc = plan.block_co
    co_tiles = -(-cog // bc)
    chans = groups * co_tiles
    nb = [-(-e // b) for e, b in zip((n, *plan.grid), plan.box)]
    boxes = math.prod(nb)
    upg = boxes * chans
    units = upg * len(plan.order) // plan.group
    out = []
    for u in range(units):
        for k in range(plan.group):
            p = plan.order[u // upg * plan.group + k]
            grp, co0 = u % chans // co_tiles, u % chans % co_tiles * bc
            t = u // chans % boxes
            qw0 = plan.origin[2] + t % nb[3] * bw
            t //= nb[3]
            qh0 = plan.origin[1] + t % nb[2] * bh
            t //= nb[2]
            qd0 = plan.origin[0] + t % nb[1] * bd
            n0 = t // nb[1] * bn
            out.append((u, k, (p, grp, co0, n0, qd0, qh0, qw0)))
    return out


def wgmma_model(x, w, kw, plan, shift=(0, 0, 0)):
    """The sums igemm_bf16_wgmma_kernel stores, [N, *out, Co] float64 (NaN
    where nothing was stored), and how often each element was stored: x
    [N, D, H, W, Ci] and w [taps, Cig, Co] float64.  ``shift`` is added to
    every A box's origin (a slip the checks must catch)."""
    kernel, stride, dil = kw["kernel"], kw["stride"], kw["dilation"]
    groups, lo, out_sp = kw["groups"], kw["crop_lo"], kw["out_spatial"]
    n, ci, co = x.shape[0], x.shape[-1], w.shape[-1]
    cig, cog = ci // groups, co // groups
    bc, rows = plan.block_co, tiling.WGMMA_ROWS
    kc = tiling.WGMMA_CHANNELS
    heads, offs = plan_taps(kernel, stride, dil)
    w2 = w.reshape(-1, co)
    y = np.full((n, *out_sp, co), np.nan)
    stored = np.zeros((n, *out_sp, co), np.int64)
    for _, _, (p, grp, co0, n0, qd0, qh0, qw0) in tiles_of(plan, n, groups,
                                                           cog):
        tap0, ntaps = heads[p]
        acc = np.zeros((rows, bc))
        for s in range(ntaps * (cig // kc)):
            tp, c = divmod(s, cig // kc)
            m = offs[tap0 + tp]
            a = tma_box(x, (n0, qd0 - m[0] + shift[0], qh0 - m[1] + shift[1],
                             qw0 - m[2] + shift[2], grp * cig + c * kc),
                        (*plan.box, kc))
            krow = (tap0 + tp) * cig + c * kc
            b = np.concatenate([
                tma_box(w2, (krow, grp * cog + co0 + hb * tiling.WGMMA_B_COLS),
                        (kc, tiling.WGMMA_B_COLS))
                for hb in range(bc // tiling.WGMMA_B_COLS)], axis=1)
            acc += a.reshape(rows, kc) @ b
        pd_, ph_, pw_ = np.unravel_index(p, stride)
        for r in range(rows):
            iw = r % plan.box[3]
            ih = r // plan.box[3] % plan.box[2]
            id_ = r // (plan.box[3] * plan.box[2]) % plan.box[1]
            nn = n0 + r // (plan.box[3] * plan.box[2] * plan.box[1])
            o = ((qd0 + id_) * stride[0] + pd_ - lo[0],
                 (qh0 + ih) * stride[1] + ph_ - lo[1],
                 (qw0 + iw) * stride[2] + pw_ - lo[2])
            if nn >= n or any(not 0 <= v < e for v, e in zip(o, out_sp)):
                continue
            cols = [c for c in range(bc) if co0 + c < cog]
            y[(nn, *o, slice(grp * cog + co0, grp * cog + co0 + len(cols)))] \
                = acc[r, :len(cols)]
            stored[(nn, *o, slice(grp * cog + co0,
                                  grp * cog + co0 + len(cols)))] += 1
    return y, stored


def _operands(xs, kernel, stride, co, crop, out, groups=1, dil=(1, 1, 1),
              seed=0):
    rng = np.random.default_rng(seed)
    ci = xs[-1]
    x = rng.standard_normal(xs)
    w = rng.standard_normal((math.prod(kernel), ci // groups, co))
    kw = dict(kernel=kernel, stride=stride, dilation=dil, groups=groups,
              crop_lo=crop, out_spatial=out)
    return x, w, kw


def _plan(x, w, kw, batch=None):
    return tiling.plan_wgmma(
        kw["kernel"], kw["stride"], kw["dilation"], kw["crop_lo"],
        kw["out_spatial"], x.shape[-1] // kw["groups"],
        w.shape[-1] // kw["groups"], kw["groups"], 1,
        batch or x.shape[0])


def _plain(x, w, kw):
    return dref.deconv_fwd_plain(torch.from_numpy(x), torch.from_numpy(w),
                                 **kw).numpy()


MODEL_CASES = [
    # (tag, x shape, kernel, stride, co, crop_lo, out_spatial, groups, dil)
    ("dcgan.deconv1", (2, 4, 1, 4, 128), (3, 1, 3), (2, 1, 2), 64,
     (0, 0, 0), (8, 1, 8), 1, (1, 1, 1)),
    ("vnet.up", (1, 4, 4, 2, 64), (3, 3, 3), (2, 2, 2), 32, (0, 0, 0),
     (8, 8, 4), 1, (1, 1, 1)),
    ("ragged.crop1", (3, 5, 1, 7, 64), (3, 1, 3), (2, 1, 2), 48, (1, 0, 1),
     (8, 1, 12), 1, (1, 1, 1)),
    ("dx.window_past_eq1", (1, 3, 5, 6, 64), (3, 3, 3), (2, 2, 2), 16,
     (1, 1, 1), (8, 12, 14), 1, (1, 1, 1)),
    ("groups2.co128", (1, 6, 1, 6, 128), (3, 1, 3), (2, 1, 2), 256,
     (0, 0, 0), (12, 1, 12), 2, (1, 1, 1)),
    ("dil2.empty_phases", (2, 6, 1, 5, 64), (3, 1, 3), (2, 1, 2), 16,
     (0, 0, 0), (15, 1, 13), 1, (2, 1, 2)),
]


@pytest.mark.parametrize("case", MODEL_CASES, ids=[c[0] for c in MODEL_CASES])
@pytest.mark.parametrize("group", ["planned", "all"])
def test_model_is_the_plain_version_and_stores_each_element_once(case, group):
    """Every kept output element is stored exactly once, with the plain
    version's sum, whether a unit is one tile or every phase of a box."""
    _, xs, k, s, co, crop, out, g, dil = case
    x, w, kw = _operands(xs, k, s, co, crop, out, g, dil)
    plan = _plan(x, w, kw)
    assert plan is not None
    if group == "all":
        plan = dataclasses.replace(plan, group=len(plan.order))
    y, stored = wgmma_model(x, w, kw, plan)
    assert (stored == 1).all()
    np.testing.assert_allclose(y, _plain(x, w, kw), rtol=1e-12, atol=1e-12)


def test_model_catches_a_slip():
    """A box one position off along any dim no longer sums the plain
    version's products."""
    _, xs, k, s, co, crop, out, g, dil = MODEL_CASES[2]
    x, w, kw = _operands(xs, k, s, co, crop, out, g, dil)
    plan = _plan(x, w, kw)
    want = _plain(x, w, kw)
    for shift in ((0, 0, 1), (1, 0, 0), (0, 0, -1)):
        y, _ = wgmma_model(x, w, kw, plan, shift=shift)
        assert not np.allclose(y, want), shift


def test_tma_boxes_are_the_direct_gathers_zero_filled_rows():
    """A's box at the tile's origin minus the tap's offset, zero-filled
    outside x by the TMA (origins of -1 and past the end included), holds
    the rows the gather reads: A[q, (m, ci)] = x[q - m, ci], zero where q
    - m leaves the input or the batch."""
    _, xs, k, s, co, crop, out, g, dil = MODEL_CASES[2]
    x, w, kw = _operands(xs, k, s, co, crop, out, g, dil)
    plan = _plan(x, w, kw)
    heads, offs = plan_taps(k, s, dil)
    n = x.shape[0]
    negative = past = 0
    for _, _, (p, grp, co0, n0, qd0, qh0, qw0) in tiles_of(plan, n, g, co):
        tap0, ntaps = heads[p]
        for m in offs[tap0:tap0 + ntaps]:
            origin = (n0, qd0 - m[0], qh0 - m[1], qw0 - m[2], 0)
            box = tma_box(x, origin, (*plan.box, 64))
            negative += min(origin[1:4]) < 0
            past += any(o + b > e for o, b, e in
                        zip(origin, plan.box, x.shape))
            for r in itertools.product(*(range(b) for b in plan.box)):
                q = (n0 + r[0], qd0 + r[1], qh0 + r[2], qw0 + r[3])
                src = (q[0], q[1] - m[0], q[2] - m[1], q[3] - m[2])
                inside = all(0 <= v < e for v, e in zip(src, x.shape))
                want = x[src][:64] if inside else np.zeros(64)
                np.testing.assert_array_equal(box[r], want)
    assert negative and past


# -- the planner: which launches of the paper's models take the route ---------

def _model_layers():
    """(model, layer, batch) of every forward geometry the main paths run
    in bf16: DCGAN's generator and discriminator, V-Net and the 3D-GAN's
    train graphs at their batches, the GP-GAN and 3D-GAN generators at
    4; the benchmark's DCGAN generator at 1,024 and V-Net at 8."""
    out = []
    for arch in ("dcgan", "v-net", "3d_gan"):
        cfg = get_config(arch)
        for name, graph in ST.train_graphs(cfg).items():
            out += [(f"{arch}.{name}", l, cfg.dcnn_batch)
                    for l in graph.layers]
    for arch in ("gp_gan", "3d_gan"):
        out += [(f"{arch}.gen", l, 4)
                for l in dcnn._generator_graph(arch, False).layers]
    out += [("bench.dcgan", l, 1024)
            for l in ST.train_graphs(get_config("dcgan"))["gen"].layers]
    out += [("bench.vnet", l, 8)
            for l in ST.train_graphs(get_config("v-net"))["vnet"].layers]
    return [o for o in out if not o[1].empty]


def _deconv_launches(layer, batch, dtype=BF16):
    """(which, x3, w, kwargs) of a layer's launches of deconv_fwd (a
    deconv's forward, a conv's dx), on meta tensors."""
    meta = dict(device="meta", dtype=dtype)
    x = torch.empty((batch, *layer.in_spatial, layer.cin), **meta)
    w = torch.empty(layer.weight_shape, **meta)
    if layer.op == "deconv":
        x3, wk, kw, _ = dops.deconv_kernel_args(
            x, w, layer.stride, layer.padding, dilation=layer.dilation,
            groups=layer.groups, engine=ENGINE)
        return [("fwd", x3, wk, kw)]
    dy = torch.empty((batch, *layer.out_spatial, layer.cout), **meta)
    (a, b, dkw), _ = cops.conv_backward_args(
        x, w, dy, layer.stride, layer.padding, dilation=layer.dilation,
        groups=layer.groups, engine=ENGINE, dw=False)
    return [("dx", a, b, dkw)]


def _splits(x3, w, kw):
    return dk._launch_plan(x3, w, w.shape[-1], kw["kernel"], kw["stride"],
                           kw["dilation"], kw["groups"], kw["crop_lo"],
                           kw["out_spatial"], kw["block_co"],
                           kw.get("split", "auto"), "bf16")[1]


MODEL_LAYERS = _model_layers()


@pytest.mark.parametrize("model,layer,batch", MODEL_LAYERS,
                         ids=[f"{m}:{l.name}:b{b}" for m, l, b in
                              MODEL_LAYERS])
def test_planner_choice_of_every_model_launch(model, layer, batch):
    """Each bf16 launch of deconv_fwd takes the route exactly where the
    rule holds (more than one phase, Cin/G % 64, Cout/G % 16, unsplit),
    never beside a halo; its plan's box holds 128 positions inside TMA's
    limits, its grid is the cropped grid, its order deepest phase first,
    its layout the C entry's."""
    for which, x3, w, kw in _deconv_launches(layer, batch):
        wg = dk.planned_wgmma(x3, w, **kw)
        cig = x3.shape[-1] // kw["groups"]
        cog = w.shape[-1] // kw["groups"]
        rule = (math.prod(kw["stride"]) > 1 and cig % 64 == 0
                and cog % 16 == 0 and _splits(x3, w, kw) == 1)
        tag = f"{model}:{layer.name}:{which}"
        assert (wg is not None) == rule, tag
        if wg is None:
            continue
        assert dk.planned_halo(x3, w, **kw) is None, tag
        assert math.prod(wg.box) == tiling.WGMMA_ROWS, tag
        assert max(wg.box) <= 256, tag      # TMA's most elements a dim
        assert (wg.origin, wg.grid) == tiling.cropped_grid(
            kw["stride"], kw["crop_lo"], kw["out_spatial"]), tag
        heads, _ = plan_taps(kw["kernel"], kw["stride"], kw["dilation"])
        depths = [heads[p][1] for p in wg.order]
        assert depths == sorted(depths, reverse=True), tag
        assert wg.group in (1, len(wg.order)), tag
        assert len(wg.fields()) == tiling.WGMMA_FIELDS, tag


def _planned_by_name():
    got = {}
    for model, layer, batch in MODEL_LAYERS:
        for which, x3, w, kw in _deconv_launches(layer, batch):
            got[(model, layer.name, which)] = dk.planned_wgmma(x3, w, **kw)
    return got


def test_the_named_launches_take_the_route_and_the_rest_keep_theirs():
    """DCGAN's deconv1-3 and V-Net's up1-3 take the route at the
    benchmark's batches (DCGAN in boxes of w4 x h4 x n8, w8 x h8 x n2 and
    w16 x h8, every phase of a box a unit), DCGAN's deconv4 (Cout 3) and
    V-Net's up4 (Cin 32) keep the gather; and of the training graphs the
    stride-2 convs' dx of V-Net's enc3-5 (crop_lo 1) take it."""
    got = _planned_by_name()
    for name in ("deconv1", "deconv2", "deconv3"):
        assert got[("bench.dcgan", f"dcgan.{name}", "fwd")] is not None
        assert got[("dcgan.gen", f"dcgan.{name}", "fwd")] is not None
    assert got[("bench.dcgan", "dcgan.deconv4", "fwd")] is None
    # the 2-D layers lift to (D, 1, W): the box is (n, d, h, w)
    assert [got[("bench.dcgan", f"dcgan.deconv{i}", "fwd")].box
            for i in (1, 2, 3)] == [(8, 4, 1, 4), (2, 8, 1, 8),
                                    (1, 8, 1, 16)]
    assert all(got[("bench.dcgan", f"dcgan.deconv{i}", "fwd")].group == 4
               for i in (1, 2, 3))
    for name in ("up1", "up2", "up3"):
        assert got[("bench.vnet", f"vnet.{name}", "fwd")] is not None
    assert got[("bench.vnet", "vnet.up4", "fwd")] is None
    dx = {k[1] for k, v in got.items()
          if v is not None and k[2] == "dx" and k[0] == "v-net.vnet"}
    assert dx == {"vnet.enc3", "vnet.enc4", "vnet.enc5"}
    for name in ("enc3", "enc4", "enc5"):
        wg = got[("v-net.vnet", f"vnet.{name}", "dx")]
        assert wg.origin == (0, 0, 0)       # lo 1 // 2: phase 1 keeps q 0


def test_the_dx_geometry_is_handled():
    """A stride-2 conv's dx is a deconv with crop_lo 1 whose window may
    reach past the Eq. (1) extent: the route takes it, over the cropped
    grid, and the model of that launch is the plain version."""
    layer = next(l for m, l, b in MODEL_LAYERS
                 if m == "v-net.vnet" and l.name == "vnet.enc3")
    (_, x3, w, kw), = _deconv_launches(layer, 4)
    assert kw["crop_lo"] == (1, 1, 1) and dk.planned_wgmma(x3, w, **kw)
    # the same geometry, cut to a small extent, its window past Eq. (1)
    x, wt, kws = _operands((1, 3, 4, 5, 64), kw["kernel"], kw["stride"], 32,
                           (1, 1, 1), (7, 9, 11))
    assert any(o + 1 > 2 * i + 1 for o, i in zip((7, 9, 11), (3, 4, 5)))
    plan = _plan(x, wt, kws)
    y, stored = wgmma_model(x, wt, kws, plan)
    assert (stored == 1).all()
    np.testing.assert_allclose(y, _plain(x, wt, kws), rtol=1e-12,
                               atol=1e-12)


def test_other_operands_and_launches_keep_their_route():
    """f32 x f32, bf16 x int8, int8 x int8, a misaligned x or weights, a
    split launch, Cin/G not a multiple of 64 or Cout/G not of 16, one
    phase: no wgmma staging."""
    meta = dict(device="meta")
    kw = dict(kernel=(3, 1, 3), stride=(2, 1, 2), out_spatial=(8, 1, 8),
              block_co=128)
    x = torch.empty((1024, 4, 1, 4, 1024), dtype=BF16, **meta)
    w = torch.empty((9, 1024, 512), dtype=BF16, **meta)
    assert dk.planned_wgmma(x, w, **kw) is not None
    assert dk.planned_wgmma(x.float(), w.float(), **kw) is None
    assert dk.planned_wgmma(x, w.to(torch.int8), **kw) is None
    assert dk.planned_wgmma(x.float(), w.to(torch.int8), **kw) is None
    # a batch of 1 leaves the bf16 tile's grid short of a wave: split
    one = torch.empty((1, 4, 1, 4, 1024), dtype=BF16, **meta)
    assert _splits(one, w, dict(kw, dilation=(1, 1, 1), groups=1,
                                crop_lo=(0, 0, 0))) > 1
    assert dk.planned_wgmma(one, w, **kw) is None
    assert dk.planned_wgmma(x[..., :96].contiguous(), w[:, :96], **kw) \
        is None
    assert dk.planned_wgmma(x, w[..., :24].contiguous(), **kw) is None
    assert dk.planned_wgmma(x, w[:1], **dict(kw, kernel=(1, 1, 1),
                                              stride=(1, 1, 1),
                                              out_spatial=(4, 1, 4))) is None
    # real tensors: aligned, then x or w one element off 16 bytes
    xs = torch.zeros((64 * 16 * 16 * 256 + 8,), dtype=BF16)
    ws = torch.zeros((9 * 256 * 128 + 8,), dtype=BF16)
    kw3 = dict(kernel=(3, 1, 3), stride=(2, 1, 2), out_spatial=(32, 1, 32),
               block_co=128)
    xa = xs[:64 * 16 * 16 * 256].view(64, 16, 1, 16, 256)
    wa = ws[:9 * 256 * 128].view(9, 256, 128)
    assert dk.planned_wgmma(xa, wa, **kw3) is not None
    assert dk.planned_wgmma(xs[1:1 + 64 * 16 * 16 * 256].view(64, 16, 1, 16, 256),
                            wa, **kw3) is None
    assert dk.planned_wgmma(xa, ws[1:1 + 9 * 256 * 128].view(9, 256, 128),
                            **kw3) is None


def test_cropped_grid_keeps_only_positions_some_phase_stores():
    """The cropped grid holds every position with a kept output in some
    phase and no position whose outputs the crop drops in every phase;
    the I + M - 1 grid holds such positions along every dim (the rows the
    gather computes and drops), at the shares the models' deconvs give."""
    for stride, lo, out, i in (((2, 2, 2), (0, 0, 0), (8, 16, 16), (4, 8, 8)),
                               ((2, 1, 2), (1, 0, 1), (9, 1, 12), (5, 1, 7)),
                               ((2, 2, 2), (1, 1, 1), (8, 12, 14),
                                (3, 5, 6))):
        origin, grid = tiling.cropped_grid(stride, lo, out)
        for d in range(3):
            kept = {q for q in range(-4, 64) for p in range(stride[d])
                    if 0 <= q * stride[d] + p - lo[d] < out[d]}
            assert kept == set(range(origin[d], origin[d] + grid[d]))
    ratios = {}
    for model, layer, batch in MODEL_LAYERS:
        if model not in ("bench.dcgan", "bench.vnet") or layer.op != "deconv":
            continue
        (_, x3, w, kw), = _deconv_launches(layer, 1)
        full = dref.phase_rows(tuple(x3.shape[1:4]), kw["kernel"],
                               kw["stride"], kw["dilation"], kw["crop_lo"],
                               kw["out_spatial"])
        _, grid = tiling.cropped_grid(kw["stride"], kw["crop_lo"],
                                      kw["out_spatial"])
        stored = math.prod(kw["out_spatial"])
        assert math.prod(grid) * math.prod(kw["stride"]) == stored
        ratios[layer.name] = math.prod(full) * math.prod(kw["stride"]) / stored
    want = {"dcgan.deconv1": 1.56, "dcgan.deconv2": 1.27,
            "dcgan.deconv3": 1.13, "dcgan.deconv4": 1.06, "vnet.up1": 1.58,
            "vnet.up2": 1.27, "vnet.up3": 1.13, "vnet.up4": 1.06}
    assert {k: round(v, 2) for k, v in ratios.items()} == want


def test_boxes_tile_the_models_grids_exactly():
    """At the models' grids (powers of two) the boxes hold no position
    past the grid: no tile holds a position the crop drops in every
    phase."""
    for model, layer, batch in MODEL_LAYERS:
        for which, x3, w, kw in _deconv_launches(layer, batch):
            wg = dk.planned_wgmma(x3, w, **kw)
            if wg is None or not model.startswith("bench.") \
                    or which != "fwd":
                continue
            assert all(e % b == 0 for e, b in zip((batch, *wg.grid),
                                                  wg.box)), layer.name


def test_work_units_fill_the_card_evenly_or_take_one_tile():
    """All phases a unit where the units fill the persistent blocks'
    rounds at least WGMMA_UNIT_FILL evenly, else one tile a unit."""
    blocks = tiling.SMS * tiling.WGMMA_MIN_BLOCKS
    assert tiling.wgmma_group(2 * blocks, 4) == 4
    assert tiling.wgmma_group(4 * blocks - 10, 8) == 8
    assert tiling.wgmma_group(blocks + 1, 4) == 1
    assert tiling.wgmma_group(16, 8) == 1


# -- the plan against the source --------------------------------------------------

def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+)", SOURCE).group(1))


def test_plan_layout_mirrors_the_source():
    """WgmmaPlan's fields, in order, and their count; the constants the
    planner shares with the kernel; the staging it reports."""
    body = re.search(r"struct WgmmaPlan \{(.*?)\};", SOURCE, re.S).group(1)
    names = re.findall(r"int ([A-Za-z0-9_, \[\]]+);", body)
    flat = [n.strip() for group in names for n in group.split(",")]
    assert flat == ["bn", "bd", "bh", "bw", "q0d", "q0h", "q0w", "Pd", "Ph",
                    "Pw", "block_co", "stages", "nphases", "group",
                    f"order[{tiling.WGMMA_MAX_PHASES}]"]
    assert len(flat) - 1 + tiling.WGMMA_MAX_PHASES == tiling.WGMMA_FIELDS
    assert re.search(r"FIELDS = 14 \+ MAX_PHASES", SOURCE)
    assert _const("MAX_PHASES") == tiling.WGMMA_MAX_PHASES
    assert _const("ROWS") == tiling.WGMMA_ROWS
    assert _const("KC") == tiling.WGMMA_CHANNELS
    assert _const("BCOLS") == tiling.WGMMA_B_COLS
    assert _const("MIN_BLOCKS") == tiling.WGMMA_MIN_BLOCKS
    assert _const("STAGING") == build.STAGINGS.index("wgmma")
    plan = _plan(*_operands(*MODEL_CASES[0][1:7]))
    f = plan.fields()
    assert f[:4] == plan.box and f[4:7] == plan.origin
    assert f[7:10] == plan.grid and f[10] == plan.block_co
    assert f[11] == tiling.WGMMA_STAGES[plan.block_co]
    assert f[12] == len(plan.order) and f[13] == plan.group
    assert f[14:14 + len(plan.order)] == plan.order
    assert set(f[14 + len(plan.order):]) <= {-1}


@pytest.mark.parametrize("block_co", sorted(tiling.WGMMA_STAGES))
def test_shared_memory_mirrors_the_kernel(block_co):
    """The planner's stages and bytes against the source's constexprs, and
    two blocks an SM: their shared memory and their registers."""
    stages = re.search(r"return BN == 128 \? (\d+) : (\d+);", SOURCE)
    want = {128: int(stages.group(1)), 64: int(stages.group(2))}
    assert tiling.WGMMA_STAGES == want
    rows, row_bytes = _const("ROWS"), _const("ROW_BYTES")
    a_bytes = rows * row_bytes
    b_box = _const("KC") * row_bytes
    stage = a_bytes + block_co // _const("BCOLS") * b_box
    assert tiling.wgmma_stage_bytes(block_co) == stage
    assert re.search(r"stages<BN>\(\) \* stage_bytes<BN>\(\) \+ 1024 \+ 16 "
                     r"\* stages<BN>\(\)", SOURCE)
    smem = want[block_co] * stage + 1024 + 16 * want[block_co]
    assert tiling.wgmma_smem_bytes(block_co) == smem
    assert smem <= tiling.SMEM_BUDGET
    assert tiling.WGMMA_MIN_BLOCKS * (
        smem + tiling.SMEM_RESERVED_PER_BLOCK) <= tiling.SMEM_PER_SM
    threads = 128 * _const("CONSUMERS") + 32
    assert re.search(r"THREADS = 128 \* CONSUMERS \+ 32", SOURCE)
    assert re.search(r"static_assert\(REGISTERS == 112", SOURCE)
    assert tiling.WGMMA_MIN_BLOCKS * threads * 112 <= \
        tiling.REGISTERS_PER_SM


# -- the wrapper's records -----------------------------------------------------

def test_record_operands_raises_when_the_entry_reports_another_staging():
    x = torch.zeros(1, 2, 1, 2, 64, dtype=BF16)
    w = torch.zeros(9, 64, 16, dtype=BF16)
    launched = build.launched_buffer()
    launched[0], launched[1] = build.LAUNCHED_ROUTES.index("bf16"), 1
    wgmma = build.STAGINGS.index("wgmma")
    for reported, planned in ((0, "wgmma"), (1, "wgmma"), (wgmma, "gather"),
                              (wgmma, "halo")):
        launched[2] = reported
        with pytest.raises(RuntimeError, match="staging"):
            build.record_operands({}, x, w, launched, staging={},
                                  halo=planned == "halo",
                                  wgmma=planned == "wgmma")
    launched[2] = wgmma
    record, staging = {}, {}
    key = build.record_operands(record, x, w, launched, staging=staging,
                                wgmma=True)
    assert key == ("bfloat16", "bfloat16", "bf16", 1, "wgmma")
    assert staging == {("bfloat16", "bfloat16", "bf16", "wgmma"): 1}
    assert build.STAGINGS == ("gather", "halo", "wgmma")


class _FakeLib:
    """The forward C entry as the card's library answers: the route it
    launched."""

    def __init__(self, staging):
        self.staging, self.calls = staging, []

    def repro_deconv_fwd(self, *args):
        geom, halo, plan, launched = args[7], args[15], args[16], args[17]
        self.calls.append((list(geom), halo,
                           None if plan is None else list(plan)))
        launched[0] = build.LAUNCHED_ROUTES.index("bf16")
        launched[1], launched[2] = 1, build.STAGINGS.index(self.staging)
        return 0


def test_a_wgmma_launch_is_recorded_and_counted(monkeypatch):
    """The wrapper hands the forward C entry the plan's fields as its
    wgmma argument, records the launch under ("bfloat16", "bfloat16",
    "bf16", "wgmma"), counts one in wgmma_launches_total{op="deconv"}
    while a profiler records (obs.profiled), and raises when the entry
    reports another staging; a gather launch passes a null plan and
    counts nothing."""
    tel = obs.Telemetry.create(ring_capacity=16)
    monkeypatch.setattr(obs, "profiled", lambda t: tel)
    monkeypatch.setattr(build, "stream_of", lambda t: 0)
    monkeypatch.setattr(dk, "staging_launches", {})
    monkeypatch.setattr(dk, "operand_launches", {})
    x, w, kw = _operands(*MODEL_CASES[0][1:7])
    xt, wt = torch.from_numpy(x).to(BF16), torch.from_numpy(w).to(BF16)
    plan = _plan(x, w, kw)
    y = torch.empty((2, 8, 1, 8, 64), dtype=BF16)
    taps = common.tap_table(kw["kernel"], kw["stride"], kw["dilation"], "cpu")
    geom = (2, 4, 1, 4, 128, 64, 1, 3, 1, 3, 2, 1, 2, 1, 1, 1, 4, 1, 4, 8, 1,
            8, 0, 0, 0, 1, 256)

    def launch(lib, wg):
        return dk._launch(lib, xt, wt, taps, None, None, y, None, geom,
                          "relu", 0.2, 64, "auto", 3, None, wg)

    lib = _FakeLib("wgmma")
    before = dk.launches
    assert launch(lib, plan) is y and dk.launches == before + 1
    assert lib.calls == [(list(geom), None, list(plan.fields()))]
    assert dk.staging_launches == {("bfloat16", "bfloat16", "bf16",
                                    "wgmma"): 1}
    assert tel.registry.get("wgmma_launches_total", op="deconv").value == 1
    with pytest.raises(RuntimeError, match="staging"):
        launch(_FakeLib("gather"), plan)
    assert tel.registry.get("wgmma_launches_total", op="deconv").value == 1
    lib = _FakeLib("gather")
    assert launch(lib, None) is y
    assert lib.calls == [(list(geom), None, None)]
    assert dk.staging_launches[("bfloat16", "bfloat16", "bf16",
                                "gather")] == 1
    assert tel.registry.get("wgmma_launches_total", op="deconv").value == 1
