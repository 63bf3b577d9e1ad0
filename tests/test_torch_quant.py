"""The port's quantization against the JAX package's (``repro.quant``).

The same inputs, made from a seed with numpy, go through the JAX function
and the port's: ``qint8`` bit for bit (both round half to even), the
``Precision`` policy and the engine's compat shim at config time, the
calibration observers, ``quantize_weights`` over every tree it accepts,
the int8-weight deconv across the reference's 24-case matrix, and the
backward through int8 weights.  The JAX side runs its Pallas kernels in
interpret mode on the CPU, as ``tests/test_quant.py`` does; the port runs
its kernels' plain versions.

Tolerances are the reference's: ``rtol=1e-5, atol=2e-5`` for the int8-
weight op against JAX's and against the float op on the dequantized
weights (f32 sums of the same exact products in another order), 5 % of
max |y| against full precision (symmetric absmax per-cout int8), and the
``test_vjp_matches_dequantized_reference`` tolerances for the gradients.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import quant as jq  # noqa: E402
from repro.core.engine import EngineConfig as JaxConfig  # noqa: E402
from repro.core.engine import UniformEngine as JaxEngine  # noqa: E402
from repro_torch import quant as tq  # noqa: E402
from repro_torch.core.engine import EngineConfig, UniformEngine  # noqa: E402
from repro_torch.core.networks import UniformLayer  # noqa: E402

JENG = JaxEngine(JaxConfig(method="pallas"))
TENG = UniformEngine(device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(t):
    return jnp.asarray(t.numpy())


# ---------------------------------------------------------------------------
# qint8: the one round/clip/scale codepath
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axis", [None, -1, 0])
def test_absmax_scale_bit_equal(axis):
    x = np.random.default_rng(0).normal(size=(3, 3, 4, 8)).astype(
        np.float32)
    got = tq.absmax_scale(_t(x), axis=axis)
    ref = np.asarray(jq.absmax_scale(jnp.asarray(x), axis=axis))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)


def test_quantize_q8_ties_and_clip_bit_equal():
    # exact .5 ties round half to even in both (0.5 -> 0, 1.5 -> 2,
    # -2.5 -> -2); values past the range clip to +-127, never -128
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 127.4,
                  300.0, -300.0, -127.6, 0.0], np.float32)
    s = np.float32(1.0)
    got = tq.quantize_q8(_t(x), torch.tensor(s))
    ref = np.asarray(jq.quantize_q8(jnp.asarray(x), s))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got.tolist() == [0, 2, 2, 0, -2, -2, 126, -126, 127, 127, -127,
                            -127, 0]
    # ties under a per-channel scale as well
    w = np.array([[0.25, 0.75], [-0.25, 0.6]], np.float32)
    sc = np.array([0.5, 0.5], np.float32)
    np.testing.assert_array_equal(
        tq.quantize_q8(_t(w), _t(sc)).numpy(),
        np.asarray(jq.quantize_q8(jnp.asarray(w), jnp.asarray(sc))))


def test_quantize_and_dequantize_int8_bit_equal():
    x = np.random.default_rng(1).normal(size=(64,)).astype(np.float32)
    q, s = tq.quantize_int8(_t(x))
    jqv, js = jq.quantize_int8(jnp.asarray(x))
    assert s.dim() == 0 and float(s) == float(js)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(tq.dequantize_int8(q, s).numpy(),
                                  np.asarray(jq.dequantize_int8(jqv, js)))
    # an all-zero tensor quantizes to zeros at the floored scale
    zq, zs = tq.quantize_int8(torch.zeros(4))
    assert float(zs) == pytest.approx(tq.SCALE_FLOOR / tq.QMAX)
    assert not zq.any()


def test_public_surface_matches_reference():
    assert tq.__all__ == jq.__all__
    assert (tq.QMAX, tq.SCALE_FLOOR, tq.QUANT_MODES) == \
        (jq.QMAX, jq.SCALE_FLOOR, jq.QUANT_MODES)
    assert (tq.NOMINAL_OPERAND_BYTES, tq.INT8_OPERAND_BYTES) == \
        (jq.NOMINAL_OPERAND_BYTES, jq.INT8_OPERAND_BYTES)


# ---------------------------------------------------------------------------
# Precision policy + config validation
# ---------------------------------------------------------------------------

def test_precision_validates_at_config_time():
    with pytest.raises(ValueError, match="accumulate"):
        tq.Precision(accumulate=torch.bfloat16)
    with pytest.raises(ValueError, match="weight_quant"):
        tq.Precision(weight_quant="int4")
    with pytest.raises(ValueError, match="act_quant"):
        tq.Precision(act_quant="fp8")
    with pytest.raises(ValueError, match="requires weight_quant"):
        tq.Precision(act_quant="int8")
    with pytest.raises(ValueError, match="channel_axis"):
        tq.Precision(weight_quant="int8", channel_axis=0)
    with pytest.raises((TypeError, ValueError)):
        tq.Precision(storage="not-a-dtype")
    with pytest.raises(ValueError, match="numeric"):
        tq.Precision(storage=torch.bool)
    assert tq.Precision(weight_quant="int8").weight_bytes == 1
    assert tq.Precision().weight_bytes == 2
    assert tq.Precision(weight_quant="int8", act_quant="int8").act_bytes == 1
    # the port's planner charges real widths
    assert tq.Precision().operand_bytes(torch.float32) == (4, 4)
    assert tq.Precision(weight_quant="int8").operand_bytes(
        torch.bfloat16) == (2, 1)
    assert tq.Precision(weight_quant="int8", act_quant="int8").operand_bytes(
        torch.float32) == (1, 1)


@pytest.mark.parametrize("kw", [
    {}, dict(weight_quant="int8"),
    dict(weight_quant="int8", act_quant="int8"),
    dict(storage="bfloat16"), dict(weight_quant="int8", storage="float32")])
def test_precision_describe_matches_reference(kw):
    tkw = {k: getattr(torch, v) if k == "storage" else v
           for k, v in kw.items()}
    jkw = {k: getattr(jnp, v) if k == "storage" else v
           for k, v in kw.items()}
    t, j = tq.Precision(**tkw), jq.Precision(**jkw)
    assert t.describe() == j.describe()
    assert (t.weight_bytes, t.act_bytes, t.quantized) == \
        (j.weight_bytes, j.act_bytes, j.quantized)


def test_engineconfig_compat_shim():
    legacy = EngineConfig(preferred_element_type=torch.bfloat16,
                          device="cpu")
    new = EngineConfig(precision=tq.Precision(storage=torch.bfloat16),
                       device="cpu")
    # the two spellings are the same config: equal, same hash
    assert legacy == new and hash(legacy) == hash(new)
    assert legacy.precision == tq.Precision(storage=torch.bfloat16)
    assert new.preferred_element_type == torch.bfloat16
    assert EngineConfig(device="cpu").precision == tq.Precision()
    # replace() round-trips a normalized config (both fields set, equal)
    again = dataclasses.replace(legacy, strict_vmem=True)
    assert again.precision.storage == torch.bfloat16
    with pytest.raises(ValueError, match="conflicts"):
        EngineConfig(preferred_element_type=torch.float32,
                     precision=tq.Precision(storage=torch.bfloat16))
    with pytest.raises(ValueError, match="Precision"):
        EngineConfig(precision="int8")
    # the kernels store f32 or bf16 only
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        EngineConfig(precision=tq.Precision(storage=torch.int8))
    with pytest.raises(ValueError, match="precision"):
        UniformLayer(name="l", in_spatial=(4, 4), cin=4, cout=4,
                     kernel=(3, 3), stride=(2, 2), precision="int8")
    layer = UniformLayer(name="l", in_spatial=(4, 4), cin=4, cout=4,
                         kernel=(3, 3), stride=(2, 2),
                         precision=tq.Precision(weight_quant="int8"))
    assert layer.precision.describe() == "w:int8"


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------

def _weights(seed=2, shape=(3, 3, 4, 8), scale=0.2):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(
        np.float32)


def test_absmax_observer_and_quantize_tensor_bit_equal():
    w = _weights()
    got = tq.quantize_tensor(_t(w))
    ref = jq.quantize_tensor(jnp.asarray(w))
    np.testing.assert_array_equal(got["scale"].numpy(),
                                  np.asarray(ref["scale"]))
    np.testing.assert_array_equal(got["w_q"].numpy(), np.asarray(ref["w_q"]))
    assert got["w_q"].dtype == torch.int8


def test_percentile_observer_matches_reference_and_clips_outliers():
    w = _weights(scale=0.1)
    w[0, 0, 0, 0] = 100.0                 # one rogue weight in channel 0
    s_abs = tq.absmax_observer(_t(w))
    s_pct = tq.percentile_observer(_t(w), pct=99.0)
    ref = np.asarray(jq.percentile_observer(jnp.asarray(w), pct=99.0))
    np.testing.assert_array_equal(s_pct.numpy(), ref)
    assert s_abs.shape == s_pct.shape == (8,)
    assert float(s_pct[0]) < float(s_abs[0])          # outlier clipped
    assert float(s_abs[0]) == pytest.approx(100.0 / 127.0)
    got = tq.quantize_tensor(_t(w), observer="percentile")
    want = jq.quantize_tensor(jnp.asarray(w), observer="percentile")
    np.testing.assert_array_equal(got["w_q"].numpy(), np.asarray(want["w_q"]))


def test_quantize_weights_structures():
    prec = tq.Precision(weight_quant="int8")
    w = _t(_weights())
    b = torch.zeros(8)
    ws = {"a": {"w": w, "b": b}, "bare": w}
    out = tq.quantize_weights(ws, prec)
    assert set(out["a"]) == {"w_q", "scale", "b"}
    assert out["a"]["w_q"].dtype == torch.int8
    assert out["a"]["scale"].shape == (8,) and out["a"]["b"] is b
    assert set(out["bare"]) == {"w_q", "scale"}
    lst = tq.quantize_weights([w, {"w": w, "b": b}], prec)
    assert isinstance(lst, list) and all("w_q" in e for e in lst)
    # no-quant policy is the identity
    assert tq.quantize_weights(ws, tq.Precision()) is ws
    # already-quantized entries pass through
    again = tq.quantize_weights(out, prec)
    assert again["a"]["w_q"] is out["a"]["w_q"]
    with pytest.raises(ValueError, match="observer"):
        tq.quantize_tensor(w, observer="bogus")
    # the same tree as the reference's, leaf for leaf
    jout = jq.quantize_weights({"a": {"w": _j(w), "b": _j(b)}, "bare": _j(w)},
                               jq.Precision(weight_quant="int8"))
    for name in ("a", "bare"):
        for k in jout[name]:
            np.testing.assert_array_equal(out[name][k].numpy(),
                                          np.asarray(jout[name][k]))


# ---------------------------------------------------------------------------
# The int8-weight deconv across the reference's matrix
# ---------------------------------------------------------------------------

MATRIX = [
    (rank, stride, variant, epi)
    for rank in (2, 3)
    for stride in (1, 2)
    for variant in ("dense", "grouped", "dilated")
    for epi in ("none", "bias_relu")
]


def matrix_case(seed, rank, stride, variant):
    """``tests/test_quant.py::_matrix_case`` from a numpy seed."""
    rng = np.random.default_rng(seed)
    sp = {2: (5, 4), 3: (4, 3, 3)}[rank]
    groups = 2 if variant == "grouped" else 1
    dil = 2 if variant == "dilated" else 1
    ci, co = 4, 8
    x = rng.normal(size=(2, *sp, ci)).astype(np.float32)
    w = (0.2 * rng.normal(size=(*(3,) * rank, ci // groups, co))).astype(
        np.float32)
    b = (0.1 * rng.normal(size=(co,))).astype(np.float32)
    return x, w, b, (stride,) * rank, groups, dil


@pytest.mark.parametrize("rank,stride,variant,epi", MATRIX)
def test_int8_weight_deconv_matches_reference(rank, stride, variant, epi):
    x, w, b, st, groups, dil = matrix_case(rank * 10 + stride, rank, stride,
                                           variant)
    crop = ((0, 1),) * rank if stride == 2 else 0
    q = jq.quantize_tensor(jnp.asarray(w))
    kw = dict(dilation=dil, groups=groups, activation="none")
    if epi == "bias_relu":
        kw["activation"] = "relu"
    jb = jnp.asarray(b) if epi == "bias_relu" else None
    tb = _t(b) if epi == "bias_relu" else None
    ref = np.asarray(JENG.deconv(jnp.asarray(x), q["w_q"], st, crop,
                                 w_scale=q["scale"], bias=jb, **kw))
    wq, scale = _t(q["w_q"]), _t(q["scale"])
    got = TENG.deconv(_t(x), wq, st, crop, w_scale=scale, bias=tb, **kw)
    deq = TENG.deconv(_t(x), tq.dequantize_int8(wq, scale), st, crop,
                      bias=tb, **kw)
    f32 = TENG.deconv(_t(x), _t(w), st, crop, bias=tb, **kw)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), deq.numpy(), rtol=1e-5,
                               atol=2e-5)
    tol = 0.05 * float(f32.abs().max()) + 1e-6
    assert float((got - f32).abs().max()) <= tol


# ---------------------------------------------------------------------------
# Gradients through int8 weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["deconv", "conv"])
def test_vjp_matches_reference(op):
    """dx, db and dscale of an int8-weight op against JAX's VJP at the
    tolerances of ``test_vjp_matches_dequantized_reference``; the int8
    weights take no gradient."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 5, 4, 4)).astype(np.float32)
    w = (0.2 * rng.normal(size=(3, 3, 4, 8))).astype(np.float32)
    b = (0.1 * rng.normal(size=(8,))).astype(np.float32)
    q = jq.quantize_tensor(jnp.asarray(w))
    pad = ((0, 1), (0, 1)) if op == "deconv" else 1
    jop, top = ((JENG.deconv, TENG.deconv) if op == "deconv"
                else (JENG.conv, TENG.conv))

    def f_q(x, s, b):
        y = jop(x, q["w_q"], 2, pad, w_scale=s, bias=b, activation="relu")
        return jnp.sum(y ** 2)

    ref = jax.grad(f_q, argnums=(0, 1, 2))(jnp.asarray(x), q["scale"],
                                           jnp.asarray(b))
    wq = _t(q["w_q"])
    ts = [_t(x).requires_grad_(), _t(q["scale"]).requires_grad_(),
          _t(b).requires_grad_()]
    y = top(ts[0], wq, 2, pad, w_scale=ts[1], bias=ts[2], activation="relu")
    got = torch.autograd.grad((y ** 2).sum(), ts)
    for g, r, tol in zip(got, ref, (1e-5, 1e-4, 1e-5)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=tol,
                                   atol=tol)
    assert not wq.requires_grad and wq.grad is None


def test_backward_through_quantized_activations_raises():
    rng = np.random.default_rng(4)
    x = _t(rng.normal(size=(1, 5, 4, 4)).astype(np.float32))
    q = tq.quantize_tensor(_t(_weights()))
    eng = UniformEngine(EngineConfig(
        precision=tq.Precision(weight_quant="int8", act_quant="int8"),
        device="cpu"))
    # the forward runs (per-tensor act quant, scale folded into the
    # epilogue); the backward raises with the reference's message
    y = eng.deconv(x, q["w_q"], 2, ((0, 1), (0, 1)), w_scale=q["scale"])
    assert y.shape == (1, 10, 8, 8) and y.dtype == torch.float32
    xg = x.clone().requires_grad_()
    y = eng.deconv(xg, q["w_q"], 2, ((0, 1), (0, 1)), w_scale=q["scale"])
    with pytest.raises(NotImplementedError, match="quantized activations"):
        y.sum().backward()


def test_operand_pairs_and_launch_records():
    """The forward kernels take the pairs the policy produces; the dw
    kernel (which the reference never gives int8) floats only; int8
    inputs store f32; launch records count by operand types and the
    kernel and passes the C entry reports."""
    from repro_torch.kernels import build
    from repro_torch.kernels.deconv import kernel as deconv_kernel
    i8, f32, bf16 = torch.int8, torch.float32, torch.bfloat16
    assert {(f32, i8), (bf16, i8), (i8, i8)} < build.FORWARD_PAIRS
    assert (i8, f32) not in build.FORWARD_PAIRS
    assert all(i8 not in p for p in build.FLOAT_PAIRS)
    a = torch.randn(1, 3, 3, 3, 4)
    with pytest.raises(TypeError, match="int8"):
        deconv_kernel.deconv_dw(a, a.to(i8), kernel=(1, 1, 1),
                                stride=(1, 1, 1))
    assert build.default_out_dtype(a.to(i8)) == f32
    assert build.default_out_dtype(a.to(bf16)) == bf16
    tf32, s8 = build.launched_buffer(), build.launched_buffer()
    tf32[0], tf32[1] = build.LAUNCHED_ROUTES.index("tf32"), 2
    s8[0], s8[1] = build.LAUNCHED_ROUTES.index("s8"), 1
    record = {}
    build.record_operands(record, a, a.to(i8), tf32)
    build.record_operands(record, a, a.to(i8), tf32)
    build.record_operands(record, a.to(i8), a.to(i8), s8)
    assert record == {("float32", "int8", "tf32", 2): 2,
                      ("int8", "int8", "s8", 1): 1}
