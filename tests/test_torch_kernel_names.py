"""The kernel packages' public names (``repro_torch.kernels.conv`` and
``.deconv``) against the JAX package's, and the float64 loop oracles.

* Each package exports every name the reference's ``__init__`` imports.
* ``deconv_loop_oracle`` and ``conv_loop_oracle`` (float64 Python loops)
  agree with the reference's oracles within 1e-12 on the shapes of
  ``tests/test_deconv_core.py``'s cases and of
  ``tests/test_conv_pallas.py``'s oracle anchor (plus a 1-D and a 3-D
  conv of the same kind).
* The re-exported ``*_reference`` lowerings agree with the oracles within
  1e-4 in f32, and the re-exported ops run (their plain versions on the
  CPU) to the same values.
"""

import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax import enable_x64  # noqa: E402

import repro_torch.kernels.conv as tconv  # noqa: E402
import repro_torch.kernels.deconv as tdeconv  # noqa: E402
from repro.kernels.conv.ref import conv_loop_oracle as j_conv_oracle  # noqa: E402,E501
from repro.kernels.deconv.ref import (  # noqa: E402
    deconv_loop_oracle as j_deconv_oracle,
)
from repro_torch.core.engine import UniformEngine  # noqa: E402
from repro_torch.kernels.conv.ref import conv_loop_oracle  # noqa: E402

REF = Path(__file__).resolve().parents[1] / "src" / "repro" / "kernels"

# rank, I, K, S, P, ci, co (tests/test_deconv_core.py's CASES)
DECONV_CASES = [
    (1, (5,), (3,), (2,), 0, 4, 3),
    (2, (4, 5), (3, 3), (2, 2), 1, 3, 2),
    (2, (4, 4), (3, 3), (1, 1), 0, 2, 2),
    (2, (3, 3), (4, 4), (2, 2), 1, 2, 3),
    (2, (5, 3), (2, 3), (3, 2), 0, 1, 1),
    (3, (3, 4, 3), (3, 3, 3), (2, 2, 2), 1, 2, 2),
    (3, (2, 3, 4), (4, 3, 2), (2, 3, 1), 0, 3, 2),
    (3, (4, 4, 4), (3, 3, 3), (2, 2, 2), 0, 2, 4),
]

# x shape, w shape, stride, padding (test_conv_pallas.py's oracle anchor
# first)
CONV_CASES = [
    ((1, 5, 4, 2), (3, 3, 2, 3), 2, ((1, 0), (0, 1))),
    ((2, 7, 3), (3, 3, 4), 2, 1),
    ((1, 4, 5, 3, 2), (2, 3, 2, 2, 3), (1, 2, 1), ((0, 1), (1, 1), (0, 0))),
]


def _reference_names(pkg: str) -> list[str]:
    names = []
    for node in ast.parse((REF / pkg / "__init__.py").read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names += [a.asname or a.name for a in node.names]
    return names


@pytest.mark.parametrize("pkg,mod", [("conv", tconv), ("deconv", tdeconv)])
def test_packages_export_the_references_names(pkg, mod):
    names = _reference_names(pkg)
    assert names and "plan_uniform_tiles" in names
    assert [n for n in names if not hasattr(mod, n)] == []


@pytest.mark.parametrize("rank,I,K,S,P,ci,co", DECONV_CASES)
def test_deconv_oracle_and_reference(rank, I, K, S, P, ci, co):
    rng = np.random.RandomState(0)
    x = rng.randn(2, *I, ci).astype(np.float32)
    w = rng.randn(*K, ci, co).astype(np.float32)
    got = tdeconv.deconv_loop_oracle(x, w, S, P)
    with enable_x64():     # the reference's oracle keeps its float64
        want = np.asarray(j_deconv_oracle(x, w, S, P))
    assert want.dtype == np.float64 and got.dtype == torch.float64
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    ref = tdeconv.deconv_reference(torch.from_numpy(x), torch.from_numpy(w),
                                   S, P)
    assert ref.dtype == torch.float32
    np.testing.assert_allclose(ref.numpy(), got.numpy(), rtol=1e-4,
                               atol=1e-4)
    op = tdeconv.deconv(torch.from_numpy(x), torch.from_numpy(w), S, P,
                        engine=UniformEngine(device="cpu"))
    np.testing.assert_allclose(op.numpy(), got.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("xs,ws,S,P", CONV_CASES)
def test_conv_oracle_and_reference(xs, ws, S, P):
    rng = np.random.RandomState(1)
    x = rng.randn(*xs).astype(np.float32)
    w = rng.randn(*ws).astype(np.float32)
    got = conv_loop_oracle(x, w, S, P)
    with enable_x64():
        want = np.asarray(j_conv_oracle(x, w, S, P))
    assert want.dtype == np.float64 and got.dtype == torch.float64
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    rank = len(xs) - 2
    assert tuple(got.shape[1:-1]) == tconv.conv_output_shape(
        xs[1:-1], ws[:rank], S, P)
    ref = tconv.conv_reference(torch.from_numpy(x), torch.from_numpy(w),
                               S, P)
    assert ref.dtype == torch.float32
    np.testing.assert_allclose(ref.numpy(), got.numpy(), rtol=1e-4,
                               atol=1e-4)
    op = tconv.conv(torch.from_numpy(x), torch.from_numpy(w), S, P,
                    engine=UniformEngine(device="cpu"))
    np.testing.assert_allclose(op.numpy(), got.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_plan_names_are_the_planners():
    from repro_torch.core import tiling
    for mod in (tconv, tdeconv):
        assert mod.plan_uniform_tiles is tiling.plan_uniform_tiles
        assert mod.DeconvTilePlan is tiling.DeconvTilePlan
