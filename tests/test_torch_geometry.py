"""The port's geometry and layer algebra against the JAX package.

Pure bookkeeping, no kernels: the polyphase tap tables and permutations,
the output-shape rules, the lifting helpers, the epilogue and the layer
and graph specs of ``repro_torch`` must equal the reference's element for
element.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import functional as jfunc  # noqa: E402
from repro.core import networks as jnet  # noqa: E402
from repro.core.engine import conv_output_shape as j_conv_shape  # noqa: E402
from repro.kernels import common as jcommon  # noqa: E402
from repro_torch.core import functional as tfunc  # noqa: E402
from repro_torch.core import networks as tnet  # noqa: E402
from repro_torch.kernels import common as tcommon  # noqa: E402

# a small K x S x dilation matrix, each per-dim tuple mixing values
KSD = [((k, 3, 2), (s, 2, 1), (d, 1, 2))
       for k, s, d in itertools.product((1, 3, 5), (1, 2), (1, 2))]


@pytest.mark.parametrize("kernel,stride,dilation", KSD)
def test_tap_tables_match_reference(kernel, stride, dilation):
    assert tcommon.phase_taps(kernel, stride, dilation) == \
        jcommon.phase_taps(kernel, stride, dilation)
    assert tcommon.phase_major_tap_index(kernel, stride, dilation) == \
        jcommon.phase_major_tap_index(kernel, stride, dilation)
    assert tcommon.phase_major_inverse(kernel, stride, dilation) == \
        jcommon.phase_major_inverse(kernel, stride, dilation)
    assert tcommon.phase_geometry(kernel, stride, dilation) == \
        jcommon.phase_geometry(kernel, stride, dilation)
    assert tcommon.halo_depth(kernel, stride, dilation) == \
        jcommon.halo_depth(kernel, stride, dilation)
    assert tcommon.effective_kernel(kernel, dilation) == \
        jcommon.effective_kernel(kernel, dilation)


@pytest.mark.parametrize("kernel,stride,dilation", KSD[::3])
def test_phase_major_weights_match_reference(kernel, stride, dilation):
    w = np.random.default_rng(0).normal(size=(*kernel, 2, 3)).astype(
        np.float32)
    ref = np.asarray(jcommon.phase_major_weights(jnp.asarray(w), kernel,
                                                 stride, dilation))
    got = tcommon.phase_major_weights(torch.from_numpy(w), kernel, stride,
                                      dilation).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kernel,stride,dilation", KSD[1::3])
def test_tap_table_lays_out_phase_taps(kernel, stride, dilation):
    """The deconv kernel's int32 table: (start, count) per phase in
    itertools.product order, then every tap's offsets phase-major."""
    table = tcommon.tap_table(kernel, stride, dilation,
                              torch.device("cpu")).tolist()
    n_phases = int(np.prod(stride))
    heads, offs = table[:2 * n_phases], table[2 * n_phases:]
    flat = [m for _, _, taps in tcommon.phase_taps(kernel, stride, dilation)
            for m in taps]
    assert [tuple(offs[i:i + 3]) for i in range(0, len(offs), 3)] == flat
    for p_idx, _, taps in tcommon.phase_taps(kernel, stride, dilation):
        start, count = heads[2 * p_idx], heads[2 * p_idx + 1]
        assert count == len(taps) and flat[start:start + count] == taps
    assert sum(heads[1::2]) == int(np.prod(kernel))


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_lifting_matches_reference(rank):
    rng = np.random.default_rng(rank)
    x = rng.normal(size=(2, *(3 + i for i in range(rank)), 4)).astype(
        np.float32)
    w = rng.normal(size=(*(1 + i for i in range(rank)), 4, 5)).astype(
        np.float32)
    jx, jw, js, jsq = jcommon.lift_3d(jnp.asarray(x), jnp.asarray(w), 2)
    tx, tw, ts, tsq = tcommon.lift_3d(torch.from_numpy(x),
                                      torch.from_numpy(w), 2)
    assert (js, jsq) == (ts, tsq)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    vals = tuple(range(2, 2 + rank))
    assert tcommon.lift_tuple3(vals, rank) == jcommon.lift_tuple3(vals, rank)
    assert tcommon.canon_dilation(2, rank) == \
        jcommon.canon_dilation(2, rank)


@pytest.mark.parametrize("activation", ["none", "relu", "leaky_relu",
                                        "tanh"])
def test_apply_epilogue_matches_reference(activation):
    rng = np.random.default_rng(1)
    y = rng.normal(size=(3, 4, 5)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    s = rng.uniform(0.5, 2.0, size=(5,)).astype(np.float32)
    ref = np.asarray(jcommon.apply_epilogue(
        jnp.asarray(y), jnp.asarray(b), activation, 0.1,
        scale=jnp.asarray(s)))
    got = tcommon.apply_epilogue(torch.from_numpy(y), torch.from_numpy(b),
                                 activation, 0.1,
                                 scale=torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("in_sp,kernel,stride,padding,dilation", [
    ((4,), (3,), (2,), ((0, 1),), (1,)),
    ((5, 6), (3, 2), (2, 1), 1, (2, 1)),
    ((4, 5, 6), (3, 3, 3), (2, 2, 2), ((0, 1), 1, (2, 0)), (1, 2, 1)),
    ((7, 3, 4), (1, 3, 5), (3, 1, 2), 0, 1),
])
def test_shape_rules_match_reference(in_sp, kernel, stride, padding,
                                     dilation):
    rank = len(in_sp)
    assert tfunc.canon_padding(padding, rank) == \
        jfunc.canon_padding(padding, rank)
    assert tfunc.deconv_output_shape(in_sp, kernel, stride, padding,
                                     dilation) == \
        jfunc.deconv_output_shape(in_sp, kernel, stride, padding, dilation)
    assert tfunc.conv_output_shape(in_sp, kernel, stride, padding,
                                   dilation) == \
        j_conv_shape(in_sp, kernel, stride, padding, dilation)
    assert tfunc.insertion_sparsity(in_sp, kernel, stride) == \
        jfunc.insertion_sparsity(in_sp, kernel, stride)


def _layer_facts(l):
    return (l.name, l.op, l.in_spatial, l.cin, l.cout, l.kernel, l.stride,
            l.padding, l.groups, l.dilation, l.weight_shape, l.out_spatial,
            l.valid_macs, l.oom_macs, l.ops, l.bytes_moved(),
            l.bytes_moved(32), l.epilogue.describe(),
            l.effective_kernel)


@pytest.mark.parametrize("name", sorted(tnet.BENCHMARKS))
def test_benchmark_layers_match_reference(name):
    t_layers = tnet.BENCHMARKS[name]()
    j_layers = jnet.BENCHMARKS[name]()
    assert [_layer_facts(l) for l in t_layers] == \
        [_layer_facts(l) for l in j_layers]
    assert [_layer_facts(l) for l in tnet.scale_channels(t_layers)] == \
        [_layer_facts(l) for l in jnet.scale_channels(j_layers)]


def test_uniform_layer_variants_match_reference():
    kw = dict(name="l", in_spatial=(5, 6), cin=4, cout=6, kernel=(3, 2),
              stride=(2, 1), padding=((1, 0), 2), groups=2, dilation=2)
    for op in ("deconv", "conv"):
        assert _layer_facts(tnet.UniformLayer(op=op, **kw)) == \
            _layer_facts(jnet.UniformLayer(op=op, **kw))
    with pytest.raises(ValueError):
        tnet.UniformLayer(name="q", in_spatial=(4,), cin=2, cout=2,
                          kernel=(3,), stride=(1,), precision="int8")


def _graph_facts(g):
    return (g.order, g.output, g.in_shape, g.out_shape,
            {n: g.node_shape(n) for n in g.order},
            {n: tuple(p) for n, p in g.edges.items()},
            [_layer_facts(l) for l in g.layers])


@pytest.mark.parametrize("kw", [
    dict(in_spatial=(8, 8, 8), chans=(2, 4)),
    dict(in_spatial=(16, 16, 8), chans=(2, 4, 8), cin=3, num_classes=5),
    dict(),                                   # the full-size V-Net
])
def test_vnet_graph_matches_reference(kw):
    assert _graph_facts(tnet.vnet_graph(**kw)) == \
        _graph_facts(jnet.vnet_graph(**kw))


def test_chain_graph_matches_reference():
    t = tnet.chain_graph(tnet.deconv_stack("g", 2, 4, [8, 4, 3]))
    j = jnet.chain_graph(jnet.deconv_stack("g", 2, 4, [8, 4, 3]))
    assert _graph_facts(t) == _graph_facts(j)
    t = tnet.chain_graph(tnet.conv_stack("c", (8, 8), [(3, 4), (4, 8)]))
    j = jnet.chain_graph(jnet.conv_stack("c", (8, 8), [(3, 4), (4, 8)]))
    assert _graph_facts(t) == _graph_facts(j)
