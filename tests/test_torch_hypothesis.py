"""Property-based tests of the port, mirroring ``tests/test_properties.py``:
the reference's properties on the port's methods, and the kernels' plain
versions against the JAX package's ``xla`` method on random single
layers (rank 1-3, groups, dilation, crop and padding, every epilogue, and
extents that reach 0).

Skips cleanly when ``hypothesis`` is not installed; the empty-output
cases that need no ``hypothesis`` are in ``tests/test_torch_properties.py``.
Tolerances: f32 sums in another order, 1e-4 of the output's magnitude
(the reference's own); the linearity and adjoint identities 1e-3, as in
``tests/test_properties.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")

import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import networks as jnet  # noqa: E402
from repro.core.engine import UniformEngine as JaxEngine  # noqa: E402
from repro_torch.core import (  # noqa: E402
    UniformEngine,
    conv_nd,
    deconv_nd,
    deconv_output_shape,
    networks,
)
from repro_torch.core.functional import _flip_spatial, correlate  # noqa: E402

TOL = 1e-4


dims = st.integers(min_value=2, max_value=5)
kernels = st.integers(min_value=1, max_value=4)
strides = st.integers(min_value=1, max_value=3)
chans = st.integers(min_value=1, max_value=4)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


@settings(max_examples=25, deadline=None)
@given(i1=dims, i2=dims, k=kernels, s=strides, ci=chans, co=chans,
       seed=st.integers(0, 2 ** 16))
def test_iom_equals_oom_2d(i1, i2, k, s, ci, co, seed):
    """IOM eliminates only invalid (zero) MACs: results identical to the
    zero-inserted dense convolution for ANY geometry."""
    rng = np.random.RandomState(seed)
    x, w = _t(rng.randn(1, i1, i2, ci)), _t(rng.randn(k, k, ci, co))
    a = deconv_nd(x, w, s, 0, method="oom", device="cpu")
    b = deconv_nd(x, w, s, 0, method="iom_phase", device="cpu")
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@settings(max_examples=15, deadline=None)
@given(i1=dims, k=kernels, s=strides, ci=chans, co=chans,
       seed=st.integers(0, 2 ** 16))
def test_pallas_matches_oom_any_geometry(i1, k, s, ci, co, seed):
    rng = np.random.RandomState(seed)
    x, w = _t(rng.randn(1, i1, i1, ci)), _t(rng.randn(k, k, ci, co))
    a = deconv_nd(x, w, s, 0, method="oom", device="cpu")
    b = deconv_nd(x, w, s, 0, method="pallas", device="cpu")
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@settings(max_examples=20, deadline=None)
@given(i1=dims, i2=dims, k=kernels, s=strides, seed=st.integers(0, 2 ** 16))
def test_linearity(i1, i2, k, s, seed):
    """Deconvolution is linear in both x and w."""
    rng = np.random.RandomState(seed)
    x1, x2 = _t(rng.randn(1, i1, i2, 2)), _t(rng.randn(1, i1, i2, 2))
    w = _t(rng.randn(k, k, 2, 3))

    def f(x):
        return deconv_nd(x, w, s, 0, method="pallas", device="cpu")
    torch.testing.assert_close(f(x1 + 2.0 * x2), f(x1) + 2.0 * f(x2),
                               rtol=1e-3, atol=1e-3)


@settings(max_examples=20, deadline=None)
@given(i1=dims, i2=dims, k=kernels, seed=st.integers(0, 2 ** 16))
def test_stride1_deconv_is_full_convolution(i1, i2, k, seed):
    """With S=1 there are no inserted zeros: deconv == full convolution."""
    rng = np.random.RandomState(seed)
    x, w = _t(rng.randn(1, i1, i2, 2)), _t(rng.randn(k, k, 2, 2))
    got = deconv_nd(x, w, 1, 0, method="pallas", device="cpu")
    full = correlate(x, _flip_spatial(w), (1, 1), [(k - 1, k - 1)] * 2)
    torch.testing.assert_close(got, full, rtol=1e-4, atol=1e-4)


@settings(max_examples=20, deadline=None)
@given(i1=dims, i2=dims, k=kernels, s=strides, seed=st.integers(0, 2 ** 16))
def test_deconv_is_conv_adjoint(i1, i2, k, s, seed):
    """<deconv(x), y> == <x, conv(y)>: the transposed convolution is the
    adjoint of the strided convolution, both on the hand kernels' plain
    versions."""
    rng = np.random.RandomState(seed)
    x, w = _t(rng.randn(1, i1, i2, 2)), _t(rng.randn(k, k, 2, 3))
    dx = deconv_nd(x, w, s, 0, method="pallas", device="cpu")
    y = _t(rng.randn(*dx.shape))
    conv_y = conv_nd(y, w.transpose(-1, -2), s, 0, method="pallas",
                     device="cpu")
    lhs, rhs = float((dx * y).sum()), float((x * conv_y).sum())
    assert abs(lhs - rhs) <= 1e-3 * max(abs(lhs), abs(rhs), 1e-6)


@settings(max_examples=25, deadline=None)
@given(i=st.integers(1, 64), k=st.integers(1, 7), s=st.integers(1, 4),
       p=st.integers(0, 2))
def test_shape_law_eq1(i, k, s, p):
    out = deconv_output_shape((i,), (k,), (s,), (p,))[0]
    assert out == (i - 1) * s + k - 2 * p


@st.composite
def single_layers(draw):
    """A random layer: rank 1-3, conv or deconv, groups, dilation, a pad
    or crop per side, any epilogue; kernels and crops large enough that
    some extents reach 0 or below."""
    rank = draw(st.integers(1, 3))
    op = draw(st.sampled_from(("conv", "deconv")))
    groups = draw(st.sampled_from((1, 2)))
    cin = groups * draw(st.integers(1, 3))
    cout = groups * draw(st.integers(1, 3))
    per_dim = st.tuples(st.integers(1, 5), st.integers(1, 4),
                        st.integers(1, 3), st.integers(1, 2),
                        st.integers(0, 3), st.integers(0, 3))
    ds = [draw(per_dim) for _ in range(rank)]
    epi = networks.Epilogue(
        bias=draw(st.booleans()),
        activation=draw(st.sampled_from(networks.ACTIVATIONS)),
        alpha=0.1)
    return dict(name="probe", op=op, groups=groups, cin=cin, cout=cout,
                in_spatial=tuple(d[0] for d in ds),
                kernel=tuple(d[1] for d in ds),
                stride=tuple(d[2] for d in ds),
                dilation=tuple(d[3] for d in ds),
                padding=tuple((d[4], d[5]) for d in ds), epilogue=epi)


@settings(max_examples=25, deadline=None)
@given(spec=single_layers(), batch=st.integers(1, 2),
       seed=st.integers(0, 2 ** 16))
def test_plain_versions_match_reference_xla(spec, batch, seed):
    """The kernels' plain versions (the port's ``pallas`` method on the
    CPU) against the JAX package's ``xla`` method on a random layer."""
    epi = spec.pop("epilogue")
    tl = networks.UniformLayer(**spec, epilogue=epi)
    jl = jnet.UniformLayer(**spec, epilogue=jnet.Epilogue(
        bias=epi.bias, activation=epi.activation, alpha=epi.alpha))
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, *tl.in_spatial, tl.cin).astype(np.float32)
    w = rng.randn(*tl.weight_shape).astype(np.float32)
    b = rng.randn(tl.cout).astype(np.float32) if epi.bias else None
    want = np.asarray(JaxEngine(method="xla")(
        jl, jnp.asarray(x), jnp.asarray(w),
        None if b is None else jnp.asarray(b)))
    got = UniformEngine(device="cpu")(tl, _t(x), _t(w),
                                      None if b is None else _t(b))
    assert tuple(got.shape) == want.shape == (batch, *tl.out_spatial,
                                              tl.cout)
    scale = float(np.abs(want).max()) if want.size else 1.0
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TOL * max(scale, 1.0))
