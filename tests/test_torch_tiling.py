"""The forward kernels' planner (``repro_torch.core.tiling``).

The tile per per-group channel width, the modelled shared memory of every
instantiated tile at f32 and bf16, the split of the reduction
(``split_reduction`` / ``launch_split``) and the block counts the schedule
report gives with the splits counted.  Pure Python: no kernel runs.
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
    tile = tiling.KERNEL_TILES[block_co]
    # a stage holds k_bytes of each row's pairs at either width
    assert plan.block_ci == tile.k_bytes // nbytes == tile.block_ci(nbytes)
    assert plan.step_smem_bytes == (
        tile.stages * (tile.block_m * (tile.k_bytes + tiling.A_PAD_BYTES)
                       + tile.k_bytes * block_co)
        + 16 * tile.block_m + 16 * tiling.MAX_TAPS)
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
