"""The bf16 route of the forward kernels, on the CPU.

bf16 x bf16 launches of the deconv and conv kernels run on the bf16
tensor cores (``csrc/igemm.cuh::igemm_bf16_kernel``): one ``mma.sync``
m16n8k16 per fragment and k16 step, A read with ``ldmatrix.x4`` from the
gathered rows at the 80-byte pitch, B staged N-major at
``tiling.bf16_b_pitch`` and read with ``ldmatrix.x4.trans``, f32 sums in
the mma's registers.  The kernel runs only on the card
(``chip_smoke.py``); here: which operand pair takes which route and what
a launch records; the route's tiles against the kernel source, the
planner's shared-memory model and the residency; the bank groups of the
``ldmatrix`` row addresses; and a numpy model of the warp's fragments,
built from the PTX ISA's ``ldmatrix`` and m16n8k16 layouts and fed the
kernel's own address arithmetic, whose product must be the plain matmul
(a layout slip shows here before the card), held against the JAX
package's bf16 kernel (interpret mode) too.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.engine import EngineConfig as JaxConfig  # noqa: E402
from repro.core.engine import UniformEngine as JaxEngine  # noqa: E402
from repro_torch.core import tiling  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

F32, BF16, I8 = torch.float32, torch.bfloat16, torch.int8
IGEMM = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
         / "csrc" / "igemm.cuh").read_text()
# chip_smoke.py's gate for f32-output launches against float64 (W8_TOL)
W8_TOL = 5e-5


# -- which pair takes which route, and what a launch records ------------------

@pytest.mark.parametrize("x_dtype,w_dtype,kmajor,route", [
    (BF16, BF16, False, "bf16"), (F32, F32, False, "fma"),
    (F32, I8, False, "tf32"), (BF16, I8, False, "tf32"),
    (I8, I8, True, "s8"),
])
def test_route_of_every_operand_pair(x_dtype, w_dtype, kmajor, route):
    assert (x_dtype, w_dtype) in build.FORWARD_PAIRS
    x = torch.zeros(1, 2, 2, 2, 16).to(x_dtype)
    w = torch.zeros((1, 1, 16, 16) if kmajor else (27, 16, 16)).to(w_dtype)
    assert build.forward_route(x, w, 27 * 16) == route
    assert tiling.operand_route(x.element_size(),
                                w.element_size()) == route
    assert route in tiling.ROUTE_TILES
    assert route in tiling.NOMINAL_ROUTE_FLOPS
    # a width alone (None: the weights' width the activations') plans as
    # the pair of two such operands
    assert tiling.operand_route(2, None) == "bf16"


def test_launched_routes_mirror_the_kernels_enum():
    body = re.search(r"enum Launched \{(.*?)\};", IGEMM, re.S).group(1)
    entries = re.findall(r"LAUNCHED_(\w+) = (\d+)", body)
    assert [int(v) for _, v in entries] == list(range(len(entries)))
    assert tuple(n.lower() for n, _ in entries) == build.LAUNCHED_ROUTES
    assert build.LAUNCHED_ROUTES.index("bf16") == 3
    # and the bf16 route's launch reports it
    assert "finish<float, DECONV>(a, a.work, LAUNCHED_BF16, 1)" in IGEMM


def test_a_bf16_launch_records_the_bf16_route():
    x = torch.zeros(1, 2, 2, 2, 16, dtype=BF16)
    w = torch.zeros(27, 16, 16, dtype=BF16)
    launched = build.launched_buffer()
    with pytest.raises(RuntimeError, match="no launch"):
        build.record_operands({}, x, w, launched)
    launched[0], launched[1] = build.LAUNCHED_ROUTES.index("bf16"), 1
    record = {}
    build.record_operands(record, x, w, launched)
    build.record_operands(record, x, w, launched)
    assert record == {("bfloat16", "bfloat16", "bf16", 1): 2}
    # the split workspace holds f32 sums, as the TF32 route's
    assert build.split_workspace(3, 8, "cpu", "bf16").dtype == F32
    # a bit per operand that takes 16-byte copies (8 channels), each on
    # its own (igemm.cuh BF16_COPY_A16 / BF16_COPY_B16)
    assert re.search(r"BF16_COPY_A16 = 1, BF16_COPY_B16 = 2;", IGEMM)
    x6 = torch.zeros(1, 2, 2, 2, 6, dtype=BF16)
    w2 = torch.zeros(27, 16, 2, dtype=BF16)
    for xx, ww, cig, cog, code in ((x, w, 16, 16, 3), (x, w2, 16, 2, 1),
                                   (x6, w, 6, 16, 2), (x6, w2, 6, 2, 0)):
        assert build.copy_variant(xx, ww, cig, cog) == code


def test_the_tf32_kernel_takes_no_bf16_weights():
    """igemm_tf32_kernel is instantiated for int8 weights only: pair 1
    (bf16 x bf16) dispatches to the bf16 route's launch."""
    assert "struct PairTypes<1>" not in IGEMM
    assert re.search(r"PART < 4\) \{\s*err = launch_bf16_typed", IGEMM)
    assert 'static_assert(sizeof(TB) == 1' in IGEMM


# -- the route's tiles --------------------------------------------------------

def _kernel_tiles():
    """block_co -> (block_m, block_co, warps_m, warps_n, stages,
    min_blocks, k_bytes) of each ``Bf16Tile`` in the kernel source."""
    tiles = {}
    for bco, args in re.findall(
            r"using Bf16Tile(\d+) = MmaTile<([\d, ]+)>;", IGEMM):
        vals = tuple(int(v) for v in args.split(","))
        assert int(bco) == vals[1]
        tiles[vals[1]] = vals
    return tiles


def test_bf16_tiles_mirror_the_kernel_source():
    src = _kernel_tiles()
    assert sorted(src) == sorted(tiling.BF16_KERNEL_TILES) == [16, 32, 64,
                                                               128]
    for bco, t in tiling.BF16_KERNEL_TILES.items():
        assert src[bco] == (t.block_m, t.block_co, t.warps_m, t.warps_n,
                            t.stages, t.min_blocks, t.k_bytes)
    assert tiling.ROUTE_TILES["bf16"] is tiling.BF16_KERNEL_TILES


@pytest.mark.parametrize("block_co", sorted(tiling.BF16_KERNEL_TILES))
def test_bf16_tiles_fit_at_their_residency(block_co):
    """A stage holds ``k_bytes`` of each row's pairs (k16 steps whole),
    B's rows at ``bf16_b_pitch``; the f32 C tile takes the rings' place
    after the last stage (the larger counts); the block fits the budget
    at the residency its __launch_bounds__ is built for, which the
    planner counts; each warp owns 32 rows x a pair of n8 fragments or
    more."""
    tile = tiling.BF16_KERNEL_TILES[block_co]
    plan = tiling.plan_uniform_tiles(64, block_co, in_dtype_bytes=2,
                                     w_dtype_bytes=2)
    pairs = tile.k_bytes // 2
    assert pairs % 16 == 0 and plan.block_ci == pairs == tile.block_ci(2)
    assert (plan.block_m, plan.threads, plan.stages) == (
        tile.block_m, tile.threads, tile.stages)
    ring = tile.stages * (tile.block_m * (tile.k_bytes + tiling.A_PAD_BYTES)
                          + pairs * (2 * block_co + 16))
    smem = max(ring, tile.block_m * (block_co + 4) * 4) + 16 * (
        tile.block_m + tiling.MAX_TAPS)
    step = tiling.step_byte_model(in_dtype_bytes=2, w_dtype_bytes=2)
    assert plan.step_smem_bytes == smem == step(
        tile.block_m, pairs, block_co, tile.stages)
    assert not plan.overflows and smem <= tiling.SMEM_BUDGET
    assert tile.min_blocks * (smem + tiling.SMEM_RESERVED_PER_BLOCK) <= \
        tiling.SMEM_PER_SM
    assert tiling.resident_blocks(plan) == tile.min_blocks
    assert plan.registers == tiling.REGISTERS_PER_SM // (
        tile.threads * tile.min_blocks)
    assert tile.block_m // tile.warps_m == 32
    assert (tile.block_co // tile.warps_n) % 16 == 0


def test_split_slices_are_whole_k16_steps():
    """The kernel refuses a k_per_split that is not a multiple of 16
    pairs; the planner's slices are whole ``SPLIT_UNIT``s."""
    assert tiling.SPLIT_UNIT % 16 == 0
    assert "g.k_per_split % 16" in IGEMM
    # DCGAN's deconv1 at batch 4 (4 taps x 1024 channels deep) splits
    plan = tiling.plan_uniform_tiles(1024, 512, in_dtype_bytes=2)
    splits, per = tiling.launch_split(plan, 4 * 25, 4 * 1024, 512, 1, 4)
    assert splits > 1 and per % 16 == 0 and (splits - 1) * per < 4096


def test_modeled_cost_takes_the_bf16_roof():
    plan = tiling.plan_uniform_tiles(128, 256, mode="conv",
                                     in_dtype_bytes=2)
    terms = tiling.plan_cost_terms(plan, (18, 18, 10), (3, 3, 3),
                                   (2, 2, 2), 128, 256, mode="conv",
                                   in_dtype_bytes=2, batch=4)
    assert terms["route"] == "bf16"
    assert tiling.NOMINAL_ROUTE_FLOPS["bf16"] == 989e12
    slow = dict(tiling.NOMINAL_ROUTE_FLOPS, bf16=1e9)
    assert tiling.modeled_cost(terms) < tiling.modeled_cost(
        terms, route_flops=slow)


# -- bank groups of the ldmatrix row addresses --------------------------------

@pytest.mark.parametrize("block_co", [16, 32, 64, 128])
def test_b_pitch_puts_each_trans_matrix_on_eight_bank_groups(block_co):
    """One ``ldmatrix`` matrix reads eight 16-byte rows in one pass: at
    ``bf16_b_pitch`` (an odd multiple of 16 bytes) the eight pair rows of
    every matrix a warp reads start in eight distinct 16-byte bank groups,
    for every warp column, k16 step and fragment pair; at the unpadded
    pitch (2 x block_co bytes, an even multiple) they do not."""
    tile = tiling.BF16_KERNEL_TILES[block_co]
    wtn = block_co // tile.warps_n
    pairs = tile.k_bytes // 2
    pitch = tiling.bf16_b_pitch(block_co)
    assert pitch == 2 * block_co + 16 and (pitch // 16) % 2 == 1

    def groups(p):
        worst = 1
        for wn in range(tile.warps_n):
            for ks in range(pairs // 16):
                for j in range(0, wtn // 8, 2):
                    addrs = [_b_lane(lane, p, wn, wtn) + ks * 16 * p
                             + j * 16 for lane in range(32)]
                    for q in range(4):
                        rows = addrs[8 * q:8 * q + 8]
                        assert all(a % 16 == 0 for a in rows)
                        banks = [(a // 16) % 8 for a in rows]
                        worst = max(worst, 8 - len(set(banks)) + 1)
        return worst

    assert groups(pitch) == 1
    assert groups(2 * block_co) > 1
    with pytest.raises(ValueError, match="multiple of 16"):
        tiling.bf16_b_pitch(block_co + 8)


@pytest.mark.parametrize("k_bytes", [64, 128])
def test_a_pitch_puts_each_matrix_on_eight_bank_groups(k_bytes):
    apb = k_bytes + tiling.A_PAD_BYTES
    for i in range(2):
        for ks in range(k_bytes // 32):
            addrs = [_a_lane(lane, apb, 0, 32) + i * 16 * apb + ks * 32
                     for lane in range(32)]
            for q in range(4):
                banks = {(a // 16) % 8 for a in addrs[8 * q:8 * q + 8]}
                assert len(banks) == 8


# -- the fragment model -------------------------------------------------------
#
# Shared memory as bytes, the ldmatrix and mma.m16n8k16 fragment layouts as
# the PTX ISA gives them, and the lane addresses as the kernel computes them.

def _a_lane(lane, apb, wm, wtm):
    """The kernel's A address of ``lane`` in slot 0 (bytes from As)."""
    return (wm * wtm + (lane & 15)) * apb + (lane >> 4) * 16


def _b_lane(lane, bp, wn, wtn):
    """The kernel's B address of ``lane`` in slot 0 (bytes from Bs)."""
    return (lane & 15) * bp + (wn * wtn + (lane >> 4) * 8) * 2


def _ldmatrix_x4(smem, addrs, trans=False):
    """Four 8 x 8 b16 matrices, matrix q's rows at ``addrs[8q:8q+8]``;
    returns [32 lanes][4 regs] of (low, high) b16 values.  Lane L
    receives (row L / 4, columns 2 (L % 4), + 1) of each matrix, or with
    ``trans`` (rows 2 (L % 4), + 1, column L / 4)."""
    mats = []
    for q in range(4):
        rows = [smem[a:a + 16].view(np.uint16) for a in addrs[8 * q:8 * q + 8]]
        mats.append(np.stack(rows))          # [row][col]
    regs = []
    for lane in range(32):
        gid, tig = lane // 4, lane % 4
        if trans:
            regs.append([(m[2 * tig, gid], m[2 * tig + 1, gid])
                         for m in mats])
        else:
            regs.append([(m[gid, 2 * tig], m[gid, 2 * tig + 1])
                         for m in mats])
    return regs


def _bf16_values(bits):
    return (np.asarray(bits, np.uint32) << 16).view(np.float32).astype(
        np.float64)


def _mma_m16n8k16(a_regs, b_regs):
    """The 16 x 8 product of one m16n8k16 from the lanes' registers: A
    regs 0-3 at (row gid, k 2 tig), (gid + 8, 2 tig), (gid, 2 tig + 8),
    (gid + 8, 2 tig + 8), each a (k, k + 1) pair; B regs 0-1 at (k 2 tig,
    column gid), (2 tig + 8, gid); C as [lane][4]: (gid, 2 tig), (gid,
    2 tig + 1), (gid + 8, 2 tig), (gid + 8, 2 tig + 1).  Every element of
    A and B is filled exactly once."""
    a = np.full((16, 16), np.nan)
    b = np.full((16, 8), np.nan)
    for lane in range(32):
        gid, tig = lane // 4, lane % 4
        for r, (row, k) in enumerate(((gid, 2 * tig), (gid + 8, 2 * tig),
                                      (gid, 2 * tig + 8),
                                      (gid + 8, 2 * tig + 8))):
            for e in range(2):
                assert np.isnan(a[row, k + e])
                a[row, k + e] = _bf16_values(a_regs[lane][r][e])
        for r, k in enumerate((2 * tig, 2 * tig + 8)):
            for e in range(2):
                assert np.isnan(b[k + e, gid])
                b[k + e, gid] = _bf16_values(b_regs[lane][r][e])
    assert not np.isnan(a).any() and not np.isnan(b).any()
    c = a @ b
    return [[c[lane // 4, 2 * (lane % 4)], c[lane // 4, 2 * (lane % 4) + 1],
             c[lane // 4 + 8, 2 * (lane % 4)],
             c[lane // 4 + 8, 2 * (lane % 4) + 1]] for lane in range(32)]


def fragment_model(a_bits, b_bits, block_co, k_bytes=64, slot=1):
    """What one block of ``igemm_bf16_kernel`` computes from one stage:
    ``a_bits`` [block_m, pairs] and ``b_bits`` [pairs, block_co] bf16 bit
    patterns laid out in slot ``slot`` of the rings at the kernel's
    pitches, read by every warp with the kernel's ldmatrix addresses, its
    fragments multiplied per the m16n8k16 layout, and the sums stored to
    the C tile at the kernel's epilogue offsets; returns the C tile."""
    tile = tiling.BF16_KERNEL_TILES[block_co]
    bm, stages = tile.block_m, max(tile.stages, slot + 1)
    pairs = k_bytes // 2
    apb, bp = k_bytes + tiling.A_PAD_BYTES, tiling.bf16_b_pitch(block_co)
    assert a_bits.shape == (bm, pairs) and b_bits.shape == (pairs, block_co)
    a_ring, b_ring = stages * bm * apb, stages * pairs * bp
    smem = np.zeros(a_ring + b_ring, np.uint8)
    for r in range(bm):
        o = slot * bm * apb + r * apb
        smem[o:o + 2 * pairs] = a_bits[r].astype(np.uint16).view(np.uint8)
    for k in range(pairs):
        o = a_ring + slot * pairs * bp + k * bp
        smem[o:o + 2 * block_co] = b_bits[k].astype(np.uint16).view(
            np.uint8)
    wtm, wtn = bm // tile.warps_m, block_co // tile.warps_n
    mt, nt = wtm // 16, wtn // 8
    ctile = np.full((bm, block_co + 4), np.nan)
    for warp in range(tile.warps_m * tile.warps_n):
        wm, wn = warp % tile.warps_m, warp // tile.warps_m
        acc = np.zeros((mt, nt, 32, 4))
        a_s = [_a_lane(lane, apb, wm, wtm) + slot * bm * apb
               for lane in range(32)]
        b_s = [a_ring + _b_lane(lane, bp, wn, wtn) + slot * pairs * bp
               for lane in range(32)]
        for ks in range(pairs // 16):
            bf = [None] * nt
            for j in range(0, nt, 2):
                regs = _ldmatrix_x4(
                    smem, [b + ks * 16 * bp + j * 16 for b in b_s],
                    trans=True)
                bf[j] = [[r[0], r[1]] for r in regs]
                bf[j + 1] = [[r[2], r[3]] for r in regs]
            for i in range(mt):
                af = _ldmatrix_x4(smem, [a + i * 16 * apb + ks * 32
                                         for a in a_s])
                for j in range(nt):
                    acc[i, j] += np.asarray(_mma_m16n8k16(af, bf[j]))
        for i in range(mt):
            for j in range(nt):
                for lane in range(32):
                    gid, tig = lane // 4, lane % 4
                    for h in range(2):
                        row = wm * wtm + i * 16 + gid + h * 8
                        col = wn * wtn + j * 8 + tig * 2
                        for e in range(2):
                            assert np.isnan(ctile[row, col + e])
                            ctile[row, col + e] = acc[i, j, lane, 2 * h + e]
    return ctile[:, :block_co]


def _bf16_bits(values):
    return (torch.from_numpy(values.astype(np.float32)).to(BF16)
            .view(torch.int16).numpy().view(np.uint16))


@pytest.mark.parametrize("block_co", sorted(tiling.BF16_KERNEL_TILES))
@pytest.mark.parametrize("k_bytes", [64, 128])
def test_fragment_model_is_the_plain_matmul(block_co, k_bytes):
    """Small integers over 4 are exact in bf16 and their sums exact in
    float64, so a wrong lane, register, row or column of either operand
    shows as a changed product."""
    rng = np.random.default_rng(block_co + k_bytes)
    tile = tiling.BF16_KERNEL_TILES[block_co]
    pairs = k_bytes // 2
    a = rng.integers(-16, 17, size=(tile.block_m, pairs)) / 4
    b = rng.integers(-16, 17, size=(pairs, block_co)) / 4
    got = fragment_model(_bf16_bits(a), _bf16_bits(b), block_co, k_bytes)
    np.testing.assert_array_equal(got, a @ b)


def test_fragment_model_catches_a_slip():
    """The model is sensitive: B read without the transpose (the
    non-trans fragment of the same rows) gives another product."""
    rng = np.random.default_rng(7)
    a = rng.integers(-16, 17, size=(256, 32)) / 4
    b = rng.integers(-16, 17, size=(32, 16)) / 4
    good = fragment_model(_bf16_bits(a), _bf16_bits(b), 16)
    real = _ldmatrix_x4
    try:
        globals()["_ldmatrix_x4"] = lambda s, ad, trans=False: real(s, ad)
        bad = fragment_model(_bf16_bits(a), _bf16_bits(b), 16)
    finally:
        globals()["_ldmatrix_x4"] = real
    assert not np.array_equal(good, bad)
    np.testing.assert_array_equal(good, a @ b)


# -- the route's arithmetic against float64 and the JAX package ---------------

def _rz_f32(v):
    """float64 ``v`` rounded to f32 toward zero."""
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f.astype(np.float64)


def mma_chain(a, w, truncate=True):
    """``a @ w`` as the route sums it: bf16 operands, one m16n8k16 per k16
    step added to the f32 sums in the mma's registers; with ``truncate``
    each step's sum rounds toward zero (the tensor cores' adder, its worst
    case), else to nearest."""
    a = torch.from_numpy(a).to(BF16).double().numpy()
    w = torch.from_numpy(w).to(BF16).double().numpy()
    acc = np.zeros((a.shape[0], w.shape[1]))
    for k in range(0, a.shape[1], 16):
        s = acc + a[:, k:k + 16] @ w[k:k + 16]
        acc = _rz_f32(s) if truncate else s.astype(np.float32).astype(
            np.float64)
    return acc, a @ w


@pytest.mark.parametrize("depth", [864, 3456, 4096])
def test_truncating_sums_stay_under_the_gate(depth):
    """The depths chip_smoke.py holds against float64 at 5e-5 of max |y|:
    per-step truncation, the worst case, stays under the gate without an
    f32 register tile beside the mma's sums."""
    rng = np.random.default_rng(depth)
    a = rng.normal(size=(64, depth)).astype(np.float32)
    w = (rng.normal(size=(depth, 32)) / np.sqrt(depth)).astype(np.float32)
    got, exact = mma_chain(a, w)
    rel = np.abs(got - exact).max() / np.abs(exact).max()
    assert rel < W8_TOL / 2
    nearest, _ = mma_chain(a, w, truncate=False)
    assert np.abs(nearest - exact).max() / np.abs(exact).max() < rel


@pytest.mark.parametrize("cin,cout", [(64, 16), (96, 32)])
def test_route_matches_the_jax_bf16_kernel(cin, cout):
    """A 1x1 conv in bf16 is one matrix product: the route's arithmetic,
    rounded to the bf16 output, agrees with the JAX package's bf16 kernel
    (interpret mode; bf16 operands, f32 sums) within one bf16 rounding
    step of max |y| (chip_smoke.py's bf16 gate, 1e-2)."""
    rng = np.random.default_rng(cin)
    x = rng.normal(size=(2, 6, 5, cin)).astype(np.float32)
    w = (rng.normal(size=(1, 1, cin, cout)) / np.sqrt(cin)).astype(
        np.float32)
    jeng = JaxEngine(JaxConfig(method="pallas"))
    ref = np.asarray(jeng.conv(jnp.asarray(x, jnp.bfloat16),
                               jnp.asarray(w, jnp.bfloat16), 1, 0)
                     ).astype(np.float32)
    got, _ = mma_chain(x.reshape(-1, cin), w.reshape(cin, cout))
    got = torch.from_numpy(got).to(BF16).float().numpy().reshape(ref.shape)
    assert np.abs(got - ref).max() <= 1e-2 * np.abs(ref).max()
