"""The port's deconv and conv ops against the JAX package's Pallas ops.

On the CPU the port's kernel wrappers run their plain versions, and the
JAX side runs its Pallas kernels in interpret mode (automatic off-TPU), so
each case holds the port's op semantics (rank lifting, groups, dilation,
crop/pad, the fused epilogue, the output dtype) against the reference's.
The matrix covers every value of rank {1, 2, 3} x stride {1, 2} x K {1, 3}
x dilation {1, 2} x groups {1, 2} x the five epilogues in 11 cases per op
(each Pallas interpret call costs about a second), plus the deep-halo
case K=5, S=1 and one bf16 case per op.

Tolerances: 1e-4 atol/rtol in f32, the reference's own.  bf16 is compared
in f32 at 1e-2: both sides store bf16 after f32 sums taken in different
orders, so they may differ by one bf16 rounding step (2^-8 relative).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.engine import UniformEngine as JaxEngine  # noqa: E402
from repro.kernels.conv import ops as jconv  # noqa: E402
from repro.kernels.deconv import ops as jdeconv  # noqa: E402
from repro_torch.core.engine import UniformEngine  # noqa: E402
from repro_torch.kernels.conv import kernel as conv_kernel  # noqa: E402
from repro_torch.kernels.conv import ops as tconv  # noqa: E402
from repro_torch.kernels.deconv import kernel as deconv_kernel  # noqa: E402
from repro_torch.kernels.deconv import ops as tdeconv  # noqa: E402

EPILOGUES = ("none", "bias+relu", "tanh", "leaky_relu", "scale+bias")

# rank, stride, K, dilation, groups, epilogue, padding
MATRIX = [
    (1, 1, 1, 1, 1, "none", 0),
    (1, 2, 3, 1, 2, "bias+relu", "exact"),
    (1, 2, 3, 2, 1, "tanh", 1),
    (1, 1, 3, 2, 2, "leaky_relu", 0),
    (2, 2, 3, 1, 1, "scale+bias", "exact"),
    (2, 1, 3, 2, 1, "bias+relu", 1),
    (2, 2, 1, 1, 2, "tanh", 0),
    (2, 1, 1, 2, 2, "none", 0),
    (3, 2, 3, 2, 2, "leaky_relu", 1),
    (3, 1, 3, 1, 2, "scale+bias", "exact"),
    (3, 2, 1, 1, 1, "bias+relu", 0),
]
assert {c[5] for c in MATRIX} == set(EPILOGUES)


@pytest.fixture(scope="module")
def engines():
    return JaxEngine(method="pallas"), UniformEngine(device="cpu")


def _case(rank, k, groups, epilogue, seed, sp=5, ci=4, co=6,
          dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, *(sp - i for i in range(rank)), ci))
    w = rng.normal(size=(*(k,) * rank, ci // groups, co))
    b = rng.normal(size=(co,)) if "bias" in epilogue else None
    s = rng.uniform(0.5, 1.5, size=(co,)) if "scale" in epilogue else None
    act = {"bias+relu": "relu", "tanh": "tanh",
           "leaky_relu": "leaky_relu"}.get(epilogue, "none")
    cast = (lambda a: None if a is None else a.astype(dtype))
    return cast(x), cast(w), cast(b), cast(s), act


def _both(jop, top, engines, x, w, stride, padding, dilation, groups, b, s,
          act):
    jeng, teng = engines
    kw = dict(dilation=dilation, groups=groups, activation=act, alpha=0.1)
    ref = jop(jnp.asarray(x), jnp.asarray(w), stride, padding,
              bias=None if b is None else jnp.asarray(b),
              w_scale=None if s is None else jnp.asarray(s),
              engine=jeng, **kw)
    got = top(torch.from_numpy(x), torch.from_numpy(w), stride, padding,
              bias=None if b is None else torch.from_numpy(b),
              w_scale=None if s is None else torch.from_numpy(s),
              engine=teng, **kw)
    return np.asarray(ref), got


def _padding(padding, rank):
    return ((0, 1),) * rank if padding == "exact" else padding


@pytest.mark.parametrize("rank,stride,k,dil,groups,epilogue,padding", MATRIX)
def test_deconv_matches_pallas_reference(engines, rank, stride, k, dil,
                                         groups, epilogue, padding):
    x, w, b, s, act = _case(rank, k, groups, epilogue, seed=len(MATRIX))
    ref, got = _both(jdeconv.deconv, tdeconv.deconv, engines, x, w, stride,
                     _padding(padding, rank), dil, groups, b, s, act)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("rank,stride,k,dil,groups,epilogue,padding", MATRIX)
def test_conv_matches_pallas_reference(engines, rank, stride, k, dil, groups,
                                       epilogue, padding):
    x, w, b, s, act = _case(rank, k, groups, epilogue, seed=rank + 7 * k)
    ref, got = _both(jconv.conv, tconv.conv, engines, x, w, stride,
                     _padding(padding, rank), dil, groups, b, s, act)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("op", ["deconv", "conv"])
def test_deep_halo_k5_s1(engines, op):
    """K=5, S=1: four leading rows of overlap between neighbouring output
    rows (the reference's halo carry), asymmetric crop/pad."""
    x, w, b, _, act = _case(2, 5, 1, "bias+relu", seed=5, sp=7, ci=3, co=4)
    pad = ((2, 1), (0, 3))
    jop, top = ((jdeconv.deconv, tdeconv.deconv) if op == "deconv"
                else (jconv.conv, tconv.conv))
    ref, got = _both(jop, top, engines, x, w, 1, pad, 1, 1, b, None, act)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("op", ["deconv", "conv"])
def test_bf16_matches_pallas_reference(engines, op):
    x, w, b, _, act = _case(2, 3, 1, "bias+relu", seed=11, ci=8, co=8)
    xj, wj, bj = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, b))
    jop, top = ((jdeconv.deconv, tdeconv.deconv) if op == "deconv"
                else (jconv.conv, tconv.conv))
    ref = jop(xj, wj, 2, 1, bias=bj, activation=act, engine=engines[0])
    # the same bf16 values on both sides
    xt, wt, bt = (torch.tensor(np.asarray(a.astype(jnp.float32))).to(
        torch.bfloat16) for a in (xj, wj, bj))
    got = top(xt, wt, 2, 1, bias=bt, activation=act, engine=engines[1])
    assert got.dtype == torch.bfloat16     # the Pallas dtype rule
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=1e-2, rtol=1e-2)


def test_preferred_element_type_sets_output_dtype():
    eng = UniformEngine(device="cpu", preferred_element_type=torch.bfloat16)
    x = torch.randn(1, 4, 4, 3)
    w = torch.randn(3, 3, 3, 2)
    assert tdeconv.deconv(x, w, 2, engine=eng).dtype == torch.bfloat16
    assert tconv.conv(x, w, 1, 1, engine=eng).dtype == torch.bfloat16


@pytest.mark.parametrize("op", ["deconv", "conv"])
def test_cpu_tensors_run_the_plain_version_uncounted(op):
    """On CPU tensors the wrapper runs the plain version; ``launches``
    counts only kernel launches."""
    mod, fn = ((deconv_kernel, tdeconv.deconv) if op == "deconv"
               else (conv_kernel, tconv.conv))
    before = mod.launches
    fn(torch.randn(1, 4, 4, 2), torch.randn(3, 3, 2, 2), 2, 1,
       engine=UniformEngine(device="cpu"))
    assert mod.launches == before


@pytest.mark.parametrize("op", ["deconv", "conv"])
def test_wrappers_refuse_what_the_kernels_do_not_take(op):
    eng = UniformEngine(device="cpu")
    fn = tdeconv.deconv if op == "deconv" else tconv.conv
    x = torch.randn(1, 4, 4, 2)
    w = torch.randn(3, 3, 2, 2)
    # int8 activations take int8 weights only; int16 is no operand type
    with pytest.raises(TypeError, match="int8"):
        fn(x.to(torch.int8), w, 2, 1, engine=eng)
    with pytest.raises(TypeError):
        fn(x, w.to(torch.int16), 2, 1, engine=eng)
    with pytest.raises(TypeError):
        fn(x, w.to(torch.bfloat16), 2, 1, engine=eng)
    with pytest.raises(TypeError):
        fn(x.double(), w.double(), 2, 1, engine=eng)
    with pytest.raises(ValueError):
        fn(x, w, 2, 1, activation="gelu", engine=eng)
    with pytest.raises(ValueError):
        fn(x, torch.randn(3, 3, 2, 3), 2, 1, groups=2, engine=eng)
