"""Property-based tests of the port, mirroring ``tests/test_properties.py``,
and the port's layers with an empty output held against the JAX package.

A layer whose kernel or crop leaves no output position returns an empty
tensor on every method, of the shape the JAX package's ``xla`` method
gives (extents clipped at 0; the reference's own ``pallas`` method returns
a non-empty array for a negative extent, a defect the port does not
copy), launches nothing, and passes zero gradients back, as the
reference's ``jax.grad`` does.  On the CPU a launch is a call of the
kernel's plain version, so "launches nothing" is checked by making the
plain versions raise.

The hypothesis properties are in ``tests/test_torch_hypothesis.py``, so
that these cases never depend on ``hypothesis``.  Tolerance: f32 sums in
another order, 1e-4 of the output's magnitude (the reference's own).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import networks as jnet  # noqa: E402
from repro.core.engine import UniformEngine as JaxEngine  # noqa: E402
from repro_torch.core import (  # noqa: E402
    METHODS,
    UniformEngine,
    compile_network,
    networks,
)
from repro_torch.kernels.conv import ref as conv_ref  # noqa: E402
from repro_torch.kernels.deconv import ref as deconv_ref  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402

TOL = 1e-4

# (op, x shape, kernel, stride, padding, dilation, cout): the two empty
# layers of the JAX package's both methods, and the negative extent its
# pallas method gets wrong
EMPTY_CASES = {
    "conv_kernel_past_input": ("conv", (2, 3, 4, 2), (4, 2), (3, 3),
                               ((0, 0), (0, 1)), 1, 2),
    "deconv_crop_past_extent": ("deconv", (2, 3, 4, 4, 2), (1, 4, 1),
                                (1, 2, 2), ((2, 1), (0, 1), (0, 0)), 1, 1),
    "conv_negative_extent": ("conv", (2, 4, 4, 7, 2), (4, 3, 1), (1, 1, 1),
                             ((0, 1), (1, 1), (0, 0)), 2, 2),
}


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.fixture
def no_plain_launch(monkeypatch):
    """Make every kernel's plain version (a launch, on the CPU) raise."""
    def refuse(*a, **k):
        raise AssertionError("an empty layer reached a kernel")
    for mod, names in ((deconv_ref, ("deconv_fwd_plain", "deconv_dw_plain")),
                       (conv_ref, ("conv_fwd_plain",))):
        for name in names:
            monkeypatch.setattr(mod, name, refuse)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("case", sorted(EMPTY_CASES))
def test_empty_layer_matches_reference_xla(case, method, no_plain_launch):
    op, xs, k, s, p, dil, co = EMPTY_CASES[case]
    rng = np.random.default_rng(0)
    x, w = _rand(rng, *xs), _rand(rng, *k, xs[-1], co)
    want = getattr(JaxEngine(method="xla"), op)(
        jnp.asarray(x), jnp.asarray(w), s, p, dilation=dil)
    assert 0 in want.shape
    eng = UniformEngine(method=method, device="cpu")
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    got = getattr(eng, op)(xt, wt, s, p, dilation=dil)
    assert tuple(got.shape) == tuple(want.shape)
    assert got.dtype == torch.float32
    # nothing reaches the output, so both gradients are zeros (the
    # reference's jax.grad gives zeros of the input's shapes)
    gx, gw = torch.autograd.grad(got.sum(), (xt, wt))
    assert gx.shape == xt.shape and gw.shape == wt.shape
    assert not gx.any() and not gw.any()


def test_empty_window_with_an_input_is_the_epilogue_of_a_zero_sum(
        no_plain_launch):
    # a conv of an empty input padded to a non-empty window: no sum runs,
    # every output is the epilogue of zero
    eng = UniformEngine(device="cpu")
    x = torch.zeros((2, 0, 3, 4))
    w = torch.randn((1, 1, 4, 5))
    b = torch.linspace(-1.0, 1.0, 5)
    y = eng.conv(x, w, 1, ((1, 1), (0, 0)), bias=b, activation="relu")
    assert y.shape == (2, 2, 3, 5)
    torch.testing.assert_close(y, torch.relu(b).expand(2, 2, 3, 5))


def _empty_chain():
    # a live conv, the empty conv of F2's first case, then a deconv and a
    # conv of its empty output: the empty extent propagates
    live = networks.UniformLayer(name="live", in_spatial=(5, 6), cin=2,
                                 cout=2, kernel=(3, 3), stride=(1, 1),
                                 padding=((0, 0), (1, 1)), op="conv")
    empty = networks.UniformLayer(name="empty", in_spatial=live.out_spatial,
                                  cin=2, cout=2, kernel=(4, 2),
                                  stride=(3, 3), padding=((0, 0), (0, 1)),
                                  op="conv")
    up = networks.UniformLayer(name="up", in_spatial=empty.out_spatial,
                               cin=2, cout=3, kernel=(3, 3), stride=(2, 2),
                               padding=((0, 1), (0, 1)),
                               epilogue=networks.Epilogue(
                                   bias=True, activation="relu"))
    tail = networks.UniformLayer(name="tail", in_spatial=up.out_spatial,
                                 cin=3, cout=2, kernel=(3, 3), stride=(1, 1),
                                 padding=1, op="conv")
    return [live, empty, up, tail]


def test_empty_layer_algebra_matches_reference():
    for l in _empty_chain():
        j = jnet.UniformLayer(**{f.name: getattr(l, f.name)
                                 for f in dataclasses.fields(l)
                                 if f.name != "epilogue"})
        assert l.out_spatial == tuple(max(o, 0) for o in j.out_spatial)
    # the negative extent clips at 0 where the reference's algebra goes
    # below it
    op, xs, k, s, p, dil, co = EMPTY_CASES["conv_negative_extent"]
    kw = dict(name="n", in_spatial=xs[1:-1], cin=xs[-1], cout=co, kernel=k,
              stride=s, padding=p, op=op, dilation=dil)
    assert jnet.UniformLayer(**kw).out_spatial == (-1, 2, 7)
    neg = networks.UniformLayer(**kw)
    assert neg.out_spatial == (0, 2, 7) and neg.empty
    assert neg.valid_macs == 0


@pytest.mark.parametrize("method", METHODS)
def test_compile_network_propagates_an_empty_layer(method):
    chain = _empty_chain()
    assert [l.empty for l in chain] == [False, True, True, True]
    eng = UniformEngine(method=method, device="cpu")
    apply, report = compile_network(chain, eng, batch=2)
    assert [r.blocks > 0 for r in report.layers] == [True, False, False,
                                                      False]
    assert report.kernel_launches == (1 if method == "pallas" else 0)
    assert [r.macs == 0 for r in report.layers] == [False, True, True, True]
    gen = torch.Generator().manual_seed(0)
    ws = [torch.randn(l.weight_shape, generator=gen) for l in chain]
    ws[2] = {"w": ws[2], "b": torch.ones(3)}
    x = torch.randn((2, 5, 6, 2), generator=gen).requires_grad_()
    y = apply(ws, x)
    assert tuple(y.shape) == (2, *chain[-1].out_spatial, 2) == (2, 0, 4, 2)
    gx, = torch.autograd.grad(y.sum(), x)
    assert gx.shape == x.shape and not gx.any()
    # a graph too, and a train step's launches: the live layer's alone
    graph = networks.chain_graph(chain)
    _, greport = compile_network(graph, eng, batch=2)
    assert greport.kernel_launches == report.kernel_launches
    assert TS._graph_launches(graph, input_needs_grad=True) == {
        "deconv_fwd": 1, "conv_fwd": 1, "deconv_dw": 1, "deconv_dx": 0}


def test_compile_network_of_an_empty_layer_launches_nothing(
        no_plain_launch):
    chain = _empty_chain()[1:]
    apply, report = compile_network(chain, UniformEngine(device="cpu"),
                                    batch=2)
    assert report.kernel_launches == 0
    ws = [torch.randn(l.weight_shape) for l in chain]
    ws[1] = {"w": ws[1], "b": torch.ones(3)}
    y = apply(ws, torch.randn((2, *chain[0].in_spatial, 2)))
    assert tuple(y.shape) == (2, 0, 4, 2)
