"""The port's reference lowerings (``oom``, ``xla``, ``iom``,
``iom_phase``) against the JAX package's, on the CPU.

The same numpy inputs go through both packages: ``deconv_nd`` over
``tests/test_deconv_core.py``'s cases for every method, the engine's
``conv`` and ``deconv`` on a grouped, dilated, asymmetrically padded
geometry with a bias and relu, the output dtypes per method, the host-side
dequantization of int8 weights and fake-quantized activations
(``_dequant_host``), and ``compile_network`` of a small V-Net on each
method, all at rtol/atol 1e-4 in f32.  The lowerings scope IEEE f32 around
their library calls themselves: run with TF32 at its defaults, they see it
off and leave the flags as they were.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import quant as jquant  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import functional as jfunc  # noqa: E402
from repro.core import networks as jnet  # noqa: E402
from repro_torch import quant  # noqa: E402
from repro_torch.convert import weights_from_numpy  # noqa: E402
from repro_torch.core import functional as tfunc  # noqa: E402
from repro_torch.core import networks as tnet  # noqa: E402
from repro_torch.core.engine import (  # noqa: E402
    CONV_METHODS,
    METHODS,
    EngineConfig,
    UniformEngine,
    compile_network,
    conv_nd,
    uniform_conv_method,
)

XLA_METHODS = ("oom", "xla", "iom", "iom_phase")
TOL = dict(rtol=1e-4, atol=1e-4)

# tests/test_deconv_core.py's CASES: rank, I, K, S, P, ci, co
CASES = [
    (1, (5,), (3,), (2,), 0, 4, 3),
    (2, (4, 5), (3, 3), (2, 2), 1, 3, 2),
    (2, (4, 4), (3, 3), (1, 1), 0, 2, 2),
    (2, (3, 3), (4, 4), (2, 2), 1, 2, 3),
    (2, (5, 3), (2, 3), (3, 2), 0, 1, 1),
    (3, (3, 4, 3), (3, 3, 3), (2, 2, 2), 1, 2, 2),
    (3, (2, 3, 4), (4, 3, 2), (2, 3, 1), 0, 3, 2),
    (3, (4, 4, 4), (3, 3, 3), (2, 2, 2), 0, 2, 4),
]


def _engines(method):
    """The port's engine on the CPU and the JAX package's, same method."""
    return (UniformEngine(EngineConfig(method=method, device="cpu")),
            jengine.UniformEngine(jengine.EngineConfig(method=method)))


@functools.lru_cache(maxsize=None)
def _case(i):
    """Case ``i``'s inputs and the JAX package's ``deconv_nd`` output.
    Its methods are bit-identical (``tests/test_deconv_core.py`` holds
    each against the loop oracle), so every port method is held against
    its ``"xla"`` method: the others, and the Pallas kernel's interpret
    mode, cost seconds a case on the CPU."""
    rank, I, K, S, P, ci, co = CASES[i]
    rng = np.random.default_rng(i)
    x = rng.normal(size=(2, *I, ci)).astype(np.float32)
    w = rng.normal(size=(*K, ci, co)).astype(np.float32)
    ref = jfunc.deconv_nd(jnp.asarray(x), jnp.asarray(w), S, P,
                          method="xla")
    return x, w, np.asarray(ref)


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("method", METHODS)
def test_deconv_nd_matches_reference(method, case):
    x, w, ref = _case(case)
    _, _, _, S, P, _, _ = CASES[case]
    got = tfunc.deconv_nd(torch.from_numpy(x), torch.from_numpy(w), S, P,
                          method=method, device="cpu")
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_shape_helpers_match_reference():
    x = np.random.default_rng(0).normal(size=(1, 3, 4, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        tfunc.zero_insert(torch.from_numpy(x), (2, 3)).numpy(),
        np.asarray(jfunc.zero_insert(jnp.asarray(x), (2, 3))))
    w = np.arange(5 * 4 * 2 * 3, dtype=np.float32).reshape(5, 4, 2, 3)
    tp = tfunc.phase_kernels(torch.from_numpy(w), (2, 3))
    jp = jfunc.phase_kernels(jnp.asarray(w), (2, 3))
    assert tp.keys() == jp.keys()
    for p in jp:
        np.testing.assert_array_equal(tp[p].numpy(), np.asarray(jp[p]))
    for m in METHODS:
        assert tfunc.deconv_macs((8, 8, 8), (3, 3, 3), 64, 32, 2, m, 2) == \
            jfunc.deconv_macs((8, 8, 8), (3, 3, 3), 64, 32, 2, m, 2)
    assert tfunc.valid_mac_fraction((2, 2, 2)) == \
        jfunc.valid_mac_fraction((2, 2, 2)) == 0.125
    assert [uniform_conv_method(m) for m in METHODS] == \
        [jengine.uniform_conv_method(m) for m in METHODS]
    assert CONV_METHODS == jengine.CONV_METHODS
    with pytest.raises(ValueError, match="block_cx"):
        tfunc.deconv_nd(torch.from_numpy(x), torch.from_numpy(w[:3, :3]),
                        2, method="xla", device="cpu", block_cx=8)
    with pytest.raises(ValueError):
        conv_nd(torch.from_numpy(x), torch.from_numpy(w), method="oom",
                device="cpu")


@pytest.mark.parametrize("op", ["deconv", "conv"])
@pytest.mark.parametrize("method", XLA_METHODS)
def test_grouped_dilated_layer_matches_reference(method, op):
    """Groups 2, dilation (2, 1), asymmetric padding, bias and relu: every
    reference method routes it through ``deconv_xla`` (a deconv) or the
    ``xla`` conv, with the epilogue on the op output."""
    rng = np.random.default_rng(3)
    g, ci, co = 2, 4, 6
    x = rng.normal(size=(2, 5, 6, ci)).astype(np.float32)
    w = rng.normal(size=(3, 2, ci // g, co)).astype(np.float32)
    b = rng.normal(size=(co,)).astype(np.float32)
    pad = ((0, 1), (1, 0)) if op == "deconv" else ((1, 0), (0, 2))
    stride = (2, 1) if op == "deconv" else (2, 2)
    kw = dict(dilation=(2, 1), groups=g, activation="relu")
    tengine, jeng = _engines(method)
    got = getattr(tengine, op)(torch.from_numpy(x), torch.from_numpy(w),
                               stride, pad, bias=torch.from_numpy(b), **kw)
    ref = getattr(jeng, op)(jnp.asarray(x), jnp.asarray(w), stride, pad,
                            bias=jnp.asarray(b), **kw)
    assert got.shape == ref.shape and (got.numpy() == 0).any()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # group 0's outputs read group 0's inputs only
    x0 = x.copy()
    x0[..., : ci // g] = 0
    part = getattr(tengine, op)(torch.from_numpy(x0), torch.from_numpy(w),
                                stride, pad, dilation=(2, 1), groups=g)
    assert np.abs(part.numpy()[..., : co // g]).max() == 0
    assert np.abs(part.numpy()[..., co // g:]).max() > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("method", METHODS)
def test_output_dtypes_match_reference(method, dtype):
    """A reference lowering's deconv returns f32 unless a storage dtype is
    configured, its conv the input dtype; the hand kernels return the
    input dtype (the JAX kernel's rule, not run here: interpret mode)."""
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    x = torch.ones((1, 4, 4, 2), dtype=tdt)
    w = torch.full((3, 3, 2, 2), 0.1, dtype=tdt)
    tengine = UniformEngine(EngineConfig(method=method, device="cpu"))
    got = (tengine.deconv(x, w, 2, ((0, 1), (0, 1))).dtype,
           tengine.conv(x, w, 1, 1).dtype)
    if method == "pallas":
        assert got == (tdt, tdt)
        return
    jeng = jengine.UniformEngine(jengine.EngineConfig(method=method))
    jx, jw = jnp.ones((1, 4, 4, 2), jdt), jnp.full((3, 3, 2, 2), 0.1, jdt)
    ref = (jeng.deconv(jx, jw, 2, ((0, 1), (0, 1))).dtype,
           jeng.conv(jx, jw, 1, 1).dtype)
    assert [str(d).split(".")[-1] for d in got] == [str(d) for d in ref] == \
        ["float32", dtype]
    if dtype == "bfloat16":     # a configured storage dtype wins
        tb = UniformEngine(EngineConfig(method=method, device="cpu",
                                        preferred_element_type=tdt))
        jb = jengine.UniformEngine(jengine.EngineConfig(
            method=method, preferred_element_type=jdt))
        assert tb.deconv(x, w, 2, 0).dtype == tdt == tb.conv(x, w, 1, 1).dtype
        assert jb.deconv(jx, jw, 2, 0).dtype == jdt == \
            jb.conv(jx, jw, 1, 1).dtype


@pytest.mark.parametrize("op", ["deconv", "conv"])
@pytest.mark.parametrize("method", ["xla", "iom_phase"])
def test_int8_weights_dequantized_up_front(method, op):
    """w:int8 on a reference lowering (weights dequantized on the host)
    against the hand kernels' epilogue scale, and against the JAX
    package's same method: ``tests/test_quant.py``'s 1e-4."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(1, 5, 4, 4)).astype(np.float32)
    w = (0.2 * rng.normal(size=(3, 3, 4, 8))).astype(np.float32)
    q = quant.quantize_tensor(torch.from_numpy(w))
    jq = jquant.quantize_tensor(jnp.asarray(w))
    np.testing.assert_array_equal(q["w_q"].numpy(), np.asarray(jq["w_q"]))
    args = (2, ((0, 1), (0, 1))) if op == "deconv" else (2, 1)
    kw = dict(activation="relu")
    tengine, jeng = _engines(method)
    pallas = UniformEngine(device="cpu")
    xt = torch.from_numpy(x)
    got = getattr(tengine, op)(xt, q["w_q"], *args, w_scale=q["scale"], **kw)
    kern = getattr(pallas, op)(xt, q["w_q"], *args, w_scale=q["scale"], **kw)
    ref = getattr(jeng, op)(jnp.asarray(x), jq["w_q"], *args,
                            w_scale=jq["scale"], **kw)
    np.testing.assert_allclose(got.numpy(), kern.numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("method", ["oom", "xla"])
def test_act_quant_is_fake_quantized(method):
    """w:int8+a:int8 on a reference lowering: the activation is
    quantized and dequantized on the host (no scale folding), as in the
    JAX package; an int8 activation passes in as f32, unscaled."""
    rng = np.random.default_rng(6)
    prec = quant.Precision(weight_quant="int8", act_quant="int8")
    jprec = jquant.Precision(weight_quant="int8", act_quant="int8")
    x = rng.normal(size=(2, 4, 4, 3)).astype(np.float32)
    w = (0.3 * rng.normal(size=(3, 3, 3, 5))).astype(np.float32)
    q = quant.quantize_tensor(torch.from_numpy(w))
    jq = jquant.quantize_tensor(jnp.asarray(w))
    tengine = UniformEngine(EngineConfig(method=method, precision=prec,
                                         device="cpu"))
    jeng = jengine.UniformEngine(jengine.EngineConfig(method=method,
                                                      precision=jprec))
    for xi in (x, np.round(x * 20).astype(np.int8)):
        got = tengine.deconv(torch.from_numpy(xi), q["w_q"], 2, 0,
                             w_scale=q["scale"])
        ref = jeng.deconv(jnp.asarray(xi), jq["w_q"], 2, 0,
                          w_scale=jq["scale"])
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    xq, _ = UniformEngine._dequant_host(torch.from_numpy(x), q["w_q"],
                                         q["scale"], prec)
    assert not np.array_equal(xq.numpy(), x)
    s = np.abs(x).max() / 127
    np.testing.assert_allclose(xq.numpy(), np.round(x / s) * s, rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("method", METHODS)
def test_compile_network_vnet_matches_reference(method):
    graph_kw = dict(in_spatial=(8, 8, 8), chans=(2, 4), cin=1)
    tgraph, jgraph = tnet.vnet_graph(**graph_kw), jnet.vnet_graph(**graph_kw)
    rng = np.random.default_rng(7)
    ws = {}
    for l in jgraph.layers:
        w = (0.3 * rng.normal(size=l.weight_shape)).astype(np.float32)
        ws[l.name] = ({"w": w, "b": (0.1 * rng.normal(size=(l.cout,)))
                       .astype(np.float32)} if l.epilogue.bias else w)
    x = rng.normal(size=(2, 8, 8, 8, 1)).astype(np.float32)
    tengine = UniformEngine(EngineConfig(method=method, device="cpu"))
    apply, report = compile_network(tgraph, tengine, batch=2)
    jmethod = "xla" if method == "pallas" else method
    japply, jreport = jengine.compile_network(
        jgraph, jengine.UniformEngine(jengine.EngineConfig(method=jmethod)),
        batch=2)
    ref = np.asarray(japply({k: jnp.asarray(v) if not isinstance(v, dict)
                             else {a: jnp.asarray(b) for a, b in v.items()}
                             for k, v in ws.items()}, jnp.asarray(x)))
    with torch.inference_mode():
        got = apply(weights_from_numpy(ws, "cpu", network=tgraph),
                    torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    # the schedule plans every layer whatever the method
    assert [l.name for l in report.layers] == [l.name for l in
                                               jreport.layers]
    assert all(l.plan is not None for l in report.layers
               if l.op in ("conv", "deconv"))
    assert report.kernel_launches == (len(tgraph.layers)
                                      if method == "pallas" else 0)
    # a bf16 graph stays bf16 on every method
    with torch.inference_mode():
        yb = apply(weights_from_numpy(ws, "cpu", network=tgraph),
                   torch.from_numpy(x).to(torch.bfloat16))
    assert yb.dtype == torch.bfloat16


def test_lowerings_scope_ieee_f32_with_tf32_at_its_defaults(monkeypatch):
    """TF32 left at its defaults (cuDNN's on): every library call of the
    lowerings runs with it off, and the flags are as they were after."""
    cudnn = torch.backends.cudnn
    monkeypatch.setattr(cudnn, "allow_tf32", True)
    knobs = tfunc._tf32_knobs()
    ieee = [value for _, _, value in knobs]

    def state():
        return [getattr(mod, attr) for mod, attr, _ in knobs]

    before = state()
    assert before != ieee
    seen = []

    def spy(fn):
        def call(*a, **k):
            seen.append(state())
            return fn(*a, **k)
        return call

    for table in (tfunc._CONV, tfunc._CONV_T):
        monkeypatch.setitem(table, 2, spy(table[2]))
    monkeypatch.setattr(tfunc.torch, "tensordot", spy(torch.tensordot))
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 4, 5, 3)).astype(np.float32)
    w = rng.normal(size=(3, 3, 3, 4)).astype(np.float32)
    for m in XLA_METHODS:
        got = tfunc.deconv_nd(torch.from_numpy(x), torch.from_numpy(w), 2, 1,
                              method=m, device="cpu")
        ref = jfunc.deconv_nd(jnp.asarray(x), jnp.asarray(w), 2, 1, method=m)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
        assert state() == before and cudnn.allow_tf32 is True
    got = conv_nd(torch.from_numpy(x), torch.from_numpy(w), 2, 1,
                  device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(jengine.conv_nd(
        jnp.asarray(x), jnp.asarray(w), 2, 1)), **TOL)
    assert len(seen) >= 6 and all(s_ == ieee for s_ in seen)
    assert state() == before
