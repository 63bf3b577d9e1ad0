"""The kernels' planner (``repro_torch.core.tiling``).

Forward: the tile per per-group channel width, the modelled shared memory
of every instantiated tile of the FMA route (f32), the bf16 and TF32
routes (bf16 x bf16; int8 weights beside float activations; B's rows
padded) and the int8 x int8 route (B's stage K-major), the split of the
reduction (``split_reduction`` / ``launch_split``, on each route's
residency), the block counts the schedule report gives with the splits counted, and the
int8 route's A copy width, chosen apart from B's.  dw: the tile per layer
shape, the ring's shared memory, the split filling a wave, slices covering
the rows and the copy width per operand.  Pure Python: no kernel runs.
"""

import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import networks as tnet  # noqa: E402
from repro_torch.core import tiling  # noqa: E402
from repro_torch.core.engine import UniformEngine, compile_network  # noqa

CPU = dict(device="cpu")


@pytest.mark.parametrize("cog,block_co,threads", [
    (1, 16, 128), (2, 16, 128), (3, 16, 128), (16, 16, 128),
    (17, 32, 128), (24, 32, 128), (32, 32, 128),
    (48, 64, 128), (64, 64, 128),
    (65, 128, 256), (128, 128, 256), (1024, 128, 256),
])
def test_tile_per_group_channel_width(cog, block_co, threads):
    plan = tiling.plan_uniform_tiles(4 * 8, 4 * cog, groups=4)
    assert (plan.block_co, plan.threads) == (block_co, threads)
    tile = tiling.KERNEL_TILES[block_co]
    assert (plan.block_m, plan.stages) == (tile.block_m, tile.stages)
    # up to 32 channels a thread owns every channel of its rows and the
    # block takes 256 rows; the wide tiles hold 64 sums a thread
    if block_co <= 32:
        assert tile.tn == block_co and tile.block_m >= 256
    else:
        assert tile.tm * tile.tn == 64


@pytest.mark.parametrize("block_co", sorted(tiling.KERNEL_TILES))
@pytest.mark.parametrize("nbytes", [4, 2])
def test_every_tile_fits_the_budget(block_co, nbytes):
    plan = tiling.plan_uniform_tiles(64, block_co, in_dtype_bytes=nbytes)
    # f32 x f32 plans on the FMA route's tiles, bf16 x bf16 on the bf16
    # route's
    route = {4: "fma", 2: "bf16"}[nbytes]
    assert tiling.operand_route(nbytes, None) == route
    tile = tiling.ROUTE_TILES[route][block_co]
    # a stage holds k_bytes of each row's pairs at either width
    assert plan.block_ci == tile.k_bytes // nbytes == tile.block_ci(nbytes)
    a_ring = tile.stages * tile.block_m * (tile.k_bytes + tiling.A_PAD_BYTES)
    if route == "fma":
        ring = a_ring + tile.stages * tile.k_bytes * block_co
    else:       # B rows padded; the f32 C tile takes the rings' place
        ring = max(a_ring + tile.stages * plan.block_ci
                   * tiling.bf16_b_pitch(block_co),
                   tile.block_m * (block_co + 4) * 4)
    assert plan.step_smem_bytes == (
        ring + 16 * tile.block_m + 16 * tiling.MAX_TAPS)
    assert not plan.overflows
    assert plan.step_smem_bytes <= tiling.SMEM_BUDGET
    assert tiling.resident_blocks(plan) >= 1


def test_pins_name_the_tiles_that_exist():
    with pytest.raises(ValueError, match=r"\[16, 32, 64, 128\]"):
        tiling.plan_uniform_tiles(8, 64, block_co=48)
    f32 = tiling.KERNEL_TILES[64].block_ci(4)
    with pytest.raises(ValueError, match=f"block_ci={f32 * 2}"):
        tiling.plan_uniform_tiles(8, 64, block_ci=f32 * 2)
    assert tiling.plan_uniform_tiles(8, 64, block_ci=f32 * 2,
                                     in_dtype_bytes=2).block_ci == f32 * 2
    pinned = UniformEngine(block_co=64, **CPU)
    assert pinned.plan("conv", (4, 4, 4), (3, 3, 3), (1, 1, 1), 8,
                       3).block_co == 64


@pytest.mark.parametrize("blocks,depth", [
    (8192, 864), (264, 9216), (1000, 100000),       # grid fills the card
    (16, 100), (1, 127),                            # too shallow to cut
])
def test_no_split_when_the_grid_fills_or_the_reduction_is_short(blocks,
                                                                depth):
    splits, per = tiling.split_reduction(blocks, depth, 264)
    assert splits == 1 and per >= depth and per % tiling.SPLIT_UNIT == 0


@pytest.mark.parametrize("blocks,depth,wave,z_other", [
    (16, 4096, 264, 4), (32, 2048, 264, 4), (8, 6912, 264, 1),
    (1, 1 << 20, 528, 1), (64, 4608, 264, 1), (3, 300, 264, 8),
    (1, 1 << 24, 1 << 20, 8),                       # held to the z limit
])
def test_split_slices_cover_the_reduction(blocks, depth, wave, z_other):
    splits, per = tiling.split_reduction(blocks, depth, wave, z_other)
    assert (splits, per) == tiling.split_reduction(blocks, depth, wave,
                                                   z_other)
    assert splits > 1
    assert per % tiling.SPLIT_UNIT == 0 and per >= tiling.SPLIT_MIN_K
    slices = [(s * per, min((s + 1) * per, depth)) for s in range(splits)]
    assert slices[0][0] == 0 and slices[-1][1] == depth
    assert all(lo < hi for lo, hi in slices)                # none empty
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    assert splits * z_other <= tiling.GRID_Z_LIMIT
    assert splits <= max(2, -(-wave // blocks))


def test_launch_split_follows_the_real_grid():
    plan = tiling.plan_uniform_tiles(1024, 512, in_dtype_bytes=4)
    wave = tiling.SMS * tiling.resident_blocks(plan)
    # served DCGAN deconv1 (batch 4): 4 phases x 25 positions x 4 images
    small = tiling.launch_split(plan, 4 * 25, 4 * 1024, 512, 1, 4)
    # the same layer at batch 64 gives enough blocks by itself
    big = tiling.launch_split(plan, 64 * 25, 4 * 1024, 512, 1, 4)
    assert small[0] > 1 and big[0] == 1
    blocks = tiling.grid_blocks(plan, 100, 512, 1, 4)
    assert blocks < wave
    assert tiling.grid_blocks(plan, 100, 512, 1, 4, small[0]) == \
        blocks * small[0]


@pytest.mark.parametrize("block_co", sorted(tiling.S8_KERNEL_TILES))
def test_s8_tiles_stage_b_k_major(block_co):
    plan = tiling.plan_uniform_tiles(64, block_co, in_dtype_bytes=1,
                                     w_dtype_bytes=1)
    tile = tiling.S8_KERNEL_TILES[block_co]
    assert (plan.block_m, plan.block_ci, plan.threads, plan.stages) == (
        tile.block_m, tile.k_bytes, tile.threads, tile.stages)
    # a stage: A [block_m][64 + 16], B K-major [block_co][64 + 16] bytes
    step = tiling.step_byte_model(in_dtype_bytes=1, w_dtype_bytes=1)
    want = (tile.stages * (tile.block_m + block_co) * (64 + 16)
            + 16 * tile.block_m + 16 * tiling.MAX_TAPS)
    assert plan.step_smem_bytes == step(tile.block_m, 64, block_co,
                                        tile.stages) == want
    assert not plan.overflows
    # the kernel's __launch_bounds__ caps the registers at the residency
    # it is built for, and shared memory allows that residency
    assert plan.registers == tiling.REGISTERS_PER_SM // (
        tile.threads * tile.min_blocks)
    assert tiling.resident_blocks(plan) == tile.min_blocks
    # the float route's layout at one byte a weight would differ
    f_step = tiling.step_byte_model(in_dtype_bytes=4, w_dtype_bytes=1)
    assert f_step(tile.block_m, 64, block_co, tile.stages) != want


def test_s8_launch_split_on_its_own_residency():
    # served DCGAN deconv1 under w:int8+a:int8 (batch 4): 4 phases x 25
    # positions x 4 images, 4 taps x 1024 channels deep
    p8 = tiling.plan_uniform_tiles(1024, 512, in_dtype_bytes=1,
                                   w_dtype_bytes=1)
    rows, depth = 4 * 25, 4 * 1024
    wave = tiling.SMS * tiling.resident_blocks(p8)
    blocks = tiling.grid_blocks(p8, rows, 512, 1, 4)
    splits, per = tiling.launch_split(p8, rows, depth, 512, 1, 4)
    assert (splits, per) == tiling.split_reduction(blocks, depth, wave, 4)
    assert splits > 1 and per % 16 == 0           # B's 16-byte copies
    assert (splits - 1) * per < depth <= splits * per
    # V-Net merge4 (batch 4): the grid fills the card, one slice
    p16 = tiling.plan_uniform_tiles(48, 16, in_dtype_bytes=1,
                                    w_dtype_bytes=1)
    assert p16.block_co == 16 and tiling.resident_blocks(p16) == 2
    assert tiling.launch_split(p16, 4 * 128 * 128 * 64, 27 * 32, 16,
                               1)[0] == 1


@pytest.mark.parametrize("block_co", sorted(tiling.TF32_KERNEL_TILES))
@pytest.mark.parametrize("x_bytes,w_bytes", [(4, 1), (2, 1), (2, 2)])
def test_tf32_tiles_fit_at_their_residency(block_co, x_bytes, w_bytes):
    """The TF32 route's tiles (and the bf16 route's, which bf16 x bf16
    takes): 64 bytes of pairs a stage, B's rows at the padded pitch, the
    f32 C tile in the rings' place after the last stage (the larger of
    the two counts); each fits the budget at the residency its
    __launch_bounds__ is built for (one to three blocks an SM), and the
    planner counts that residency."""
    plan = tiling.plan_uniform_tiles(64, block_co, in_dtype_bytes=x_bytes,
                                     w_dtype_bytes=w_bytes)
    route = tiling.operand_route(x_bytes, w_bytes)
    assert route == ("bf16" if (x_bytes, w_bytes) == (2, 2) else "tf32")
    tile = tiling.ROUTE_TILES[route][block_co]
    assert (plan.block_m, plan.block_ci, plan.threads, plan.stages) == (
        tile.block_m, tile.k_bytes // x_bytes, tile.threads, tile.stages)
    pitch = (tiling.bf16_b_pitch(block_co) if route == "bf16" else
             tiling.tf32_b_pitch(x_bytes, block_co * w_bytes))
    ring = max(tile.stages * (tile.block_m * (tile.k_bytes
                                              + tiling.A_PAD_BYTES)
                              + plan.block_ci * pitch),
               tile.block_m * (block_co + 4) * 4)
    assert plan.step_smem_bytes == (ring + 16 * tile.block_m
                                    + 16 * tiling.MAX_TAPS)
    assert tile.min_blocks >= 1 and not plan.overflows
    assert tile.min_blocks * (plan.step_smem_bytes
                              + tiling.SMEM_RESERVED_PER_BLOCK) <= \
        tiling.SMEM_PER_SM
    assert plan.registers == tiling.REGISTERS_PER_SM // (
        tile.threads * tile.min_blocks)
    assert tiling.resident_blocks(plan) == tile.min_blocks
    # each warp owns 32 rows of m16n8 fragments
    assert tile.block_m // tile.warps_m == 32


def test_launch_split_follows_the_tf32_residency():
    # served DCGAN deconv1 under w:int8 (batch 4): 4 phases x 25 positions
    # x 4 images, 4 taps x 1024 channels deep, on the 128 x 128 tile of
    # sixteen warps, one block an SM
    pt = tiling.plan_uniform_tiles(1024, 512, in_dtype_bytes=4,
                                   w_dtype_bytes=1)
    pf = tiling.plan_uniform_tiles(1024, 512, in_dtype_bytes=4)
    assert (pt.block_m, pt.threads, pf.block_m) == (128, 512, 128)
    assert (tiling.resident_blocks(pt), tiling.resident_blocks(pf)) == (1, 2)
    rows, depth = 4 * 25, 4 * 1024
    wave = tiling.SMS * tiling.resident_blocks(pt)
    blocks = tiling.grid_blocks(pt, rows, 512, 1, 4)
    splits, per = tiling.launch_split(pt, rows, depth, 512, 1, 4)
    assert (splits, per) == tiling.split_reduction(blocks, depth, wave, 4)
    assert splits > 1 and per % tiling.SPLIT_UNIT == 0
    # the FMA route's grid, split to the route's own residency
    assert blocks == tiling.grid_blocks(pf, rows, 512, 1, 4)
    assert tiling.launch_split(pf, rows, depth, 512, 1, 4)[0] == 2 * splits
    # V-Net merge4 (batch 4): the grid fills the card, one slice
    p16 = tiling.plan_uniform_tiles(32, 16, in_dtype_bytes=4,
                                    w_dtype_bytes=1)
    assert tiling.resident_blocks(p16) == 3
    assert tiling.launch_split(p16, 4 * 128 * 128 * 64, 27 * 32, 16,
                               1)[0] == 1


@pytest.mark.parametrize("cig", [1, 4, 16])
@pytest.mark.parametrize("cog", [2, 16])
def test_s8_a_copy_width_apart_from_b(cig, cog):
    from repro_torch.kernels import build
    x = torch.zeros(8, 3 * cig, dtype=torch.int8)
    w = torch.zeros(1, 3, cog, 16, dtype=torch.int8)
    want = {1: 1, 4: 4, 16: 16}[cig]
    # the output channels have no say: the head (Co 2) copies 16 bytes
    assert build.a_copy_bytes(x, cig) == want
    assert build.copy_variant(x, w, cig, cog) == want
    # a base address off the copy's grid takes a narrower copy
    shifted = torch.zeros(8 * 3 * cig + 4, dtype=torch.int8)[4:]
    assert build.a_copy_bytes(shifted, cig) == min(want, 4)
    odd = torch.zeros(8 * 3 * cig + 1, dtype=torch.int8)[1:]
    assert build.a_copy_bytes(odd, cig) == 1
    # the float route keeps one flag for both operands
    wf = torch.zeros(27, cig, 3 * cog, dtype=torch.int8)
    assert build.copy_variant(x.float(), wf, cig, cog) == int(
        cig % 4 == 0 and cog % 16 == 0)


def test_schedule_report_counts_the_splits():
    graph = tnet.vnet_graph(in_spatial=(16, 16, 8), chans=(16, 32, 256))
    _, report = compile_network(graph, UniformEngine(**CPU), batch=1)
    layers = [r for r in report.layers if r.plan is not None]
    for r in layers:
        plan = r.plan
        if r.op == "conv":
            rows, phases = math.prod(r.out_spatial), 1
            depth = math.prod(r.kernel) * r.cin
        else:
            m = tuple(-(-k // s) for k, s in zip(r.kernel, r.stride))
            rows = math.prod(i + mm - 1 for i, mm in zip(r.in_spatial, m))
            phases, depth = math.prod(r.stride), math.prod(m) * r.cin
        splits, _ = tiling.launch_split(plan, rows, depth, r.cout, 1,
                                        phases)
        assert r.splits == splits
        assert r.blocks == tiling.grid_blocks(plan, rows, r.cout, 1,
                                              phases, splits)
    assert any(r.splits > 1 for r in layers)
    assert any(r.splits == 1 for r in layers)
    assert report.blocks == sum(r.blocks for r in layers)
    assert "_split" in report.describe()


# -- the dw kernel's planner -------------------------------------------------

# (A's per-group channels, taps x B's per-group channels) -> tile; the
# V-Net head, enc1 and the image layers take the narrow column tile
@pytest.mark.parametrize("ag,cols,tile", [
    (2, 16, (16, 32)), (16, 27, (16, 32)), (8, 27, (16, 32)),
    (128, 27, (16, 32)), (1024, 32, (16, 32)),
    (16, 864, (16, 256)), (12, 72, (16, 256)), (2, 432, (16, 256)),
    (17, 432, (32, 256)), (24, 108, (32, 256)), (32, 1728, (32, 256)),
    (33, 864, (64, 128)), (64, 3456, (64, 128)), (1024, 4608, (64, 128)),
])
def test_dw_tile_per_layer_shape(ag, cols, tile):
    got = tiling.dw_tile_for(ag, cols)
    assert (got.block_a, got.block_c) == tile
    taps = 27 if cols % 27 == 0 else 9 if cols % 9 == 0 else 1
    plan = tiling.plan_dw_tiles(2 * ag, 2 * (cols // taps), taps, 4096,
                                groups=2)
    assert (plan.block_a, plan.block_c) == tile


@pytest.mark.parametrize("key", sorted(tiling.DW_KERNEL_TILES))
@pytest.mark.parametrize("nbytes", [4, 2])
def test_every_dw_tile_fits_the_budget(key, nbytes):
    tile = tiling.DW_KERNEL_TILES[key]
    assert (tile.block_a, tile.block_c) == key
    # the ring and nothing else: A [rows][block_a] and B [rows][block_c]
    assert tile.smem_bytes(nbytes) == (tile.stages * tiling.DW_BLOCK_ROWS
                                       * (tile.block_a + tile.block_c)
                                       * nbytes)
    assert tile.smem_bytes(nbytes) <= tiling.SMEM_BUDGET
    assert tile.threads == (tile.block_a // tile.ta) * (tile.block_c
                                                        // tile.tc)
    assert tile.threads % 32 == 0 and tile.threads <= 1024
    assert tiling.dw_resident_blocks(tile, nbytes) >= 1
    # the big tiles hold 32 or 64 sums a thread
    if tile.block_c > tiling.DW_NARROW_COLUMNS:
        assert tile.ta * tile.tc in (32, 64)
    # a layer of exactly the tile's width gets that tile
    plan = tiling.plan_dw_tiles(key[0], key[1], 1, 4096,
                                dtype_bytes=nbytes)
    assert (plan.block_a, plan.block_c) == key


# the full-width training layers whose output gives less than a wave:
# (A channels, B channels, taps, rows)
DW_SHORT_GRIDS = [
    (16, 32, 27, 4 * 128 * 128 * 64),      # V-Net merge4
    (32, 64, 27, 4 * 64 * 64 * 32),        # merge3
    (32, 16, 27, 4 * 64 * 64 * 32),        # up4
    (64, 128, 27, 4 * 32 * 32 * 16),       # merge2
    (16, 1, 27, 4 * 128 * 128 * 64),       # enc1
    (2, 16, 1, 4 * 128 * 128 * 64),        # head
    (256, 128, 27, 4 * 8 * 8 * 4),         # up1
]


@pytest.mark.parametrize("ac,bc,taps,rows", DW_SHORT_GRIDS)
@pytest.mark.parametrize("nbytes", [4, 2])
def test_dw_split_fills_one_wave(ac, bc, taps, rows, nbytes):
    plan = tiling.plan_dw_tiles(ac, bc, taps, rows, dtype_bytes=nbytes)
    tile = tiling.DW_KERNEL_TILES[(plan.block_a, plan.block_c)]
    wave = tiling.SMS * tiling.dw_resident_blocks(tile, nbytes)
    out_blocks = plan.blocks // plan.splits
    assert out_blocks < wave and plan.splits > 1
    # within one wave, short of it by about one split's blocks (rounding
    # the slices up to whole stages may drop a few more)
    assert 0.95 * (wave - out_blocks) < plan.blocks <= wave


@pytest.mark.parametrize("ac,bc,taps,rows,groups", [
    *((ac, bc, taps, rows, 1) for ac, bc, taps, rows in DW_SHORT_GRIDS),
    (1024, 512, 9, 64 * 16, 1), (48, 24, 9, 64 * 16, 1),
    (12, 20, 27, 2 * 7 * 6 * 5, 2), (8, 3, 9, 64 * 32 * 32, 1),
    (16, 32, 27, 33, 1), (16, 32, 27, 1, 1),
])
@pytest.mark.parametrize("nbytes", [4, 2])
def test_dw_slices_cover_the_rows(ac, bc, taps, rows, groups, nbytes):
    plan = tiling.plan_dw_tiles(ac, bc, taps, rows, groups=groups,
                                dtype_bytes=nbytes)
    splits, per = plan.splits, plan.rows_per_split
    # the wrapper cuts the rows from the plan's count the same way
    assert tiling.split_rows(rows, splits) == (splits, per)
    assert per % tiling.DW_BLOCK_ROWS == 0                  # whole stages
    slices = [(s * per, min((s + 1) * per, rows)) for s in range(splits)]
    assert slices[0][0] == 0 and slices[-1][1] == rows
    assert all(lo < hi for lo, hi in slices)                # none empty
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    assert splits <= tiling.GRID_Z_LIMIT
    if splits > 1:
        assert per >= tiling.SPLIT_MIN_K


@pytest.mark.parametrize("rows,asked", [
    (4096, 1), (4096, 4), (1024, 16), (100, 4), (1 << 24, 1 << 20),
])
def test_dw_split_rows_keeps_whole_stages_within_the_z_limit(rows, asked):
    splits, per = tiling.split_rows(rows, asked)
    assert 1 <= splits <= min(asked, tiling.GRID_Z_LIMIT)
    assert per % tiling.DW_BLOCK_ROWS == 0
    assert (splits - 1) * per < rows <= splits * per
    if asked <= tiling.GRID_Z_LIMIT and rows >= asked * 32:
        assert splits == asked


@pytest.mark.parametrize("dtype,ag,bg,want", [
    (torch.float32, 16, 32, (True, True)),
    (torch.float32, 2, 16, (False, True)),
    (torch.float32, 16, 1, (True, False)),
    (torch.float32, 6, 10, (False, False)),
    (torch.bfloat16, 16, 32, (True, True)),
    (torch.bfloat16, 12, 8, (False, True)),
    (torch.bfloat16, 24, 12, (True, False)),
])
def test_dw_copy_width_per_operand(dtype, ag, bg, want):
    from repro_torch.kernels import build
    a = torch.zeros(64, 2 * ag, dtype=dtype)
    b = torch.zeros(64, 2 * bg, dtype=dtype)
    assert build.dw_vector_copies(a, b, ag, bg) == want
    # a base address off the 16-byte grid takes the scalar copies
    shifted = torch.zeros(64 * 2 * ag + 1, dtype=dtype)[1:]
    assert build.dw_vector_copies(shifted, b, ag, bg) == (False, want[1])


def test_backward_plan_names_the_dw_tile():
    eng = UniformEngine(**CPU)
    plan = eng.plan("conv", (128, 128, 64), (3, 3, 3), (1, 1, 1), 32, 16,
                    backward=True, rows=4 * 128 * 128 * 64)
    assert (plan.dw.block_a, plan.dw.block_c) == (16, 256)
    assert f"dw:a16_c256_split{plan.dw.splits}x" in plan.describe()
