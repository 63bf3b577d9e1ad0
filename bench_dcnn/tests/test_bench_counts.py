"""``counts.py`` against operations and bytes counted by hand."""

import json

from bench_dcnn import counts
from bench_dcnn.reference import vnet
from bench_dcnn.tests.tiny import BENCH


def test_2d_deconv_counts_useful_pairs_only():
    # 4x4 -> 8x8, 3x3 stride 2, the (0, 1) crop drops the last tap of the
    # last input per dim: 3 x 4 - 1 = 11 pairs a dim
    nd = {"name": "d", "op": "deconv", "in_spatial": (4, 4), "cin": 2,
          "cout": 3, "kernel": (3, 3), "stride": (2, 2),
          "padding": ((0, 1), (0, 1)), "out_spatial": (8, 8),
          "bias": ("b",)}
    assert counts.useful_macs(nd) == 11 * 11 * 2 * 3
    flops, nbytes = counts.pass_counts(nd, "fwd", batch=5, elem_bytes=2)
    assert flops == 2 * 121 * 6 * 5
    # input 4*4*2 and output 8*8*3 per sample, weights 9*2*3 plus 3 bias
    assert nbytes == 2 * ((32 + 192) * 5 + 54 + 3)


def test_3d_conv_leaves_out_the_padding():
    # 4^3, 3^3 stride 1 padding 1: per dim 3 x 4 - 2 = 10 pairs
    nd = {"name": "c", "op": "conv", "in_spatial": (4, 4, 4), "cin": 3,
          "cout": 5, "kernel": (3, 3, 3), "stride": (1, 1, 1),
          "padding": ((1, 1),) * 3, "out_spatial": (4, 4, 4)}
    assert counts.useful_macs(nd) == 10 ** 3 * 15
    for pas in ("fwd", "dx", "dw"):
        f, b = counts.pass_counts(nd, pas, batch=2, elem_bytes=4)
        assert f == 2 * 1000 * 15 * 2
        assert b == 4 * ((64 * 3 + 64 * 5) * 2 + 27 * 15)


def test_vnet_merge_and_concat_at_full_size():
    cfg = json.loads((BENCH / "configs" / "vnet.json").read_text())
    nodes = {nd["name"]: nd for nd in vnet.nodes(cfg)}
    merge4 = nodes["merge4"]
    assert (merge4["in_spatial"], merge4["cin"], merge4["cout"]) == \
        ((128, 128, 64), 32, 16)
    # stride 1, padding 1 per dim: 3n - 2 pairs
    assert counts.useful_macs(merge4) == 382 * 382 * 190 * 32 * 16
    f, b = counts.pass_counts(nodes["skip4"], "fwd", batch=8, elem_bytes=2)
    assert f == 0
    # reads 16 + 16 channels, writes 32, per voxel of 8 volumes
    assert b == 2 * 128 * 128 * 64 * (32 + 32) * 8


def test_vnet_forward_is_66_gflop_a_volume():
    cfg = json.loads((BENCH / "configs" / "vnet.json").read_text())
    total = counts.flops(vnet.work(cfg, "infer"), batch=1)
    assert 65.9e9 < total < 66.0e9
    # a step does each layer's forward, dw and, past the first, dx
    train = counts.flops(vnet.work(cfg, "train"), batch=1)
    first = 2 * counts.useful_macs(vnet.nodes(cfg)[0])
    assert train == 3 * total - first
