"""The port's backward against the JAX package's custom VJPs.

On the CPU the port's kernel wrappers run their plain versions, and the
JAX side runs its Pallas ops (forward and VJP kernels) in interpret mode,
as the JAX package's own tests do.  Each case takes dx, dw and db of
``sum(sin(op(x, w) + b))`` through both packages from the same numpy
inputs and holds them at the reference's f32 tolerance, 1e-4.  The
geometries are those of the reference's VJP tests
(``tests/test_deconv_pallas.py`` VJP_CASES, ``tests/test_conv_pallas.py``
gradient cases) plus groups, dilation, fused bias with relu/leaky/tanh,
(lo, hi) crops and the conv whose last input row no tap reads.

The remaining tests pin the plain dw against a per-tap oracle in both
operand roles, show that CPU autograd runs through the port's
``autograd.Function``s (their dx/dw wrappers are called) and check the
dw planner at the two extremes of the full-width models.
"""

import itertools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.engine import UniformEngine as JaxEngine  # noqa: E402
from repro.kernels.conv import ops as jconv  # noqa: E402
from repro.kernels.deconv import ops as jdeconv  # noqa: E402
from repro_torch.core import tiling  # noqa: E402
from repro_torch.core.engine import UniformEngine  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.conv import kernel as conv_kernel  # noqa: E402
from repro_torch.kernels.conv import ops as tconv  # noqa: E402
from repro_torch.kernels.deconv import kernel as deconv_kernel  # noqa: E402
from repro_torch.kernels.deconv import ops as tdeconv  # noqa: E402
from repro_torch.kernels.deconv import ref as deconv_ref  # noqa: E402

# op, in_spatial, kernel, stride, padding, ci, co, dilation, groups,
# epilogue ("none" | "bias+<activation>")
CASES = [
    # the reference's deconv VJP geometries
    ("deconv", (5, 6), (3, 3), 2, 1, 3, 4, 1, 1, "none"),
    ("deconv", (3, 4, 5), (3, 3, 3), 2, 0, 2, 3, 1, 1, "none"),
    ("deconv", (14, 5), (3, 3), 2, 0, 2, 2, 1, 1, "none"),
    ("deconv", (8, 5), (2, 2), 3, 0, 2, 3, 1, 1, "none"),
    ("deconv", (8, 4, 4), (7, 3, 3), 2, 1, 2, 3, 1, 1, "none"),
    # the reference's conv gradient geometries
    ("conv", (5, 6), (3, 3), 2, 1, 3, 4, 1, 1, "none"),
    ("conv", (5, 6, 4), (3, 3, 3), 1, ((1, 0), (0, 1), (1, 1)), 3, 4, 1, 1,
     "none"),
    ("conv", (7,), (3,), 2, 0, 3, 4, 1, 1, "none"),
    # groups, dilation, fused epilogues, (lo, hi) crops
    ("deconv", (5, 4), (3, 3), 2, ((0, 1), (1, 0)), 4, 6, 1, 2,
     "bias+relu"),
    ("deconv", (6,), (3,), 2, ((1, 2),), 4, 4, 2, 2, "bias+tanh"),
    ("deconv", (3, 4, 3), (3, 3, 3), 2, ((0, 1),) * 3, 2, 4, 1, 1,
     "bias+leaky_relu"),
    ("conv", (7, 6), (3, 3), 2, 1, 4, 6, 2, 2, "bias+leaky_relu"),
    ("conv", (5, 5, 4), (3, 3, 3), 1, 1, 2, 4, 1, 1, "bias+tanh"),
    # conv k3 s2 pad 0 on an extent of 8: input row 7 gets zero gradient
    ("conv", (8, 8), (3, 3), 2, 0, 3, 4, 1, 1, "bias+relu"),
]


def _ids(c):
    return f"{c[0]}-{'x'.join(map(str, c[1]))}-k{c[2][0]}s{c[3]}-{c[9]}"


@pytest.fixture(scope="module")
def engines():
    return JaxEngine(method="pallas"), UniformEngine(device="cpu")


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_grads_match_jax_pallas_vjp(engines, case):
    op, sp, k, s, pad, ci, co, dil, groups, epi = case
    jeng, teng = engines
    act = epi.split("+")[1] if "+" in epi else "none"
    rng = np.random.default_rng(len(sp) * 31 + ci)
    x = rng.normal(size=(2, *sp, ci)).astype(np.float32)
    w = rng.normal(size=(*k, ci // groups, co)).astype(np.float32)
    b = rng.normal(size=(co,)).astype(np.float32) if "bias" in epi else None
    jop, top = ((jdeconv.deconv, tdeconv.deconv) if op == "deconv"
                else (jconv.conv, tconv.conv))
    kw = dict(dilation=dil, groups=groups, activation=act, alpha=0.2)

    def jloss(x, w, b):
        return jnp.sum(jnp.sin(jop(x, w, s, pad, bias=b, engine=jeng, **kw)))

    argnums = (0, 1, 2) if b is not None else (0, 1)
    jargs = [jnp.asarray(x), jnp.asarray(w),
             None if b is None else jnp.asarray(b)]
    ref = jax.jit(jax.grad(jloss, argnums))(*jargs)

    targs = [torch.from_numpy(a).requires_grad_() for a in (x, w)]
    tb = None if b is None else torch.from_numpy(b).requires_grad_()
    y = top(targs[0], targs[1], s, pad, bias=tb, engine=teng, **kw)
    got = torch.autograd.grad(torch.sin(y).sum(),
                              targs + ([tb] if tb is not None else []))
    for name, r, g in zip(("dx", "dw", "db"), ref, got):
        assert g.shape == r.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    if case[1:4] == ((8, 8), (3, 3), 2):
        assert (got[0][:, 7].abs().max() == 0 and
                got[0][:, :, 7].abs().max() == 0)


def _dw_oracle(a, b, kernel, stride, dil, groups, lo, transpose):
    """Per-tap einsum over an explicit gather: out[t, i, g*Bg + j] =
    sum_p a[p, g*Ag + i] * b[p*S + k_t*dil - lo, g*Bg + j]."""
    n, asp, ac = a.shape[0], a.shape[1:-1], a.shape[-1]
    bc = b.shape[-1]
    ag, bg = ac // groups, bc // groups
    out = np.zeros((math.prod(kernel), ag, bc))
    for t, kk in enumerate(itertools.product(*(range(e) for e in kernel))):
        idx = [np.arange(i) * s + kj * d - l
               for i, s, kj, d, l in zip(asp, stride, kk, dil, lo)]
        ok = [(ix >= 0) & (ix < e) for ix, e in zip(idx, b.shape[1:-1])]
        mesh = np.ix_(*[np.clip(ix, 0, e - 1)
                        for ix, e in zip(idx, b.shape[1:-1])])
        valid = (ok[0][:, None, None] & ok[1][None, :, None]
                 & ok[2][None, None, :])
        win = b[(slice(None),) + mesh] * valid[None, ..., None]
        for g in range(groups):
            out[t, :, g * bg:(g + 1) * bg] = np.einsum(
                "pi,pj->ij", a[..., g * ag:(g + 1) * ag].reshape(-1, ag),
                win[..., g * bg:(g + 1) * bg].reshape(-1, bg))
    if transpose:
        out = (out.reshape(len(out), ag, groups, bg).transpose(0, 3, 2, 1)
               .reshape(len(out), bg, groups * ag))
    return out


@pytest.mark.parametrize("role", ["deconv", "conv"])
@pytest.mark.parametrize("groups,dil", [(1, 1), (2, 2)])
def test_dw_plain_matches_per_tap_oracle(role, groups, dil):
    rng = np.random.default_rng(3 + groups)
    kernel, stride = (3, 1, 2), (2, 1, 3)
    if role == "deconv":       # a = x, b = dy (Eq. (1) extent, cropped)
        a = rng.normal(size=(2, 4, 3, 5, 4))
        b = rng.normal(size=(2, 8, 3, 14, 6))
        lo, transpose = (1, 0, 2), False
    else:                      # a = dy, b = x (padded by lo)
        a = rng.normal(size=(2, 4, 3, 5, 6))
        b = rng.normal(size=(2, 9, 3, 13, 4))
        lo, transpose = (1, 0, 0), True
    got = deconv_ref.deconv_dw_plain(
        torch.from_numpy(a).float(), torch.from_numpy(b).float(),
        kernel=kernel, stride=stride, dilation=(dil, 1, dil), groups=groups,
        lo=lo, transpose=transpose)
    want = _dw_oracle(a, b, kernel, stride, (dil, 1, dil), groups, lo,
                      transpose)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    # float64 operands sum in float64 (the yardstick on the card)
    got64 = deconv_ref.deconv_dw_plain(
        torch.from_numpy(a), torch.from_numpy(b), kernel=kernel,
        stride=stride, dilation=(dil, 1, dil), groups=groups, lo=lo,
        transpose=transpose)
    assert got64.dtype == torch.float64
    np.testing.assert_allclose(got64.numpy(), want, rtol=1e-12, atol=1e-12)


def test_cpu_backward_runs_through_the_ports_functions(monkeypatch):
    """One backward of conv -> deconv calls the dx/dw wrappers exactly as
    the kernels would be launched on the card, so CPU autograd through the
    plain einsums cannot stand in for the ported backward."""
    calls = {"deconv_dw": 0, "deconv_dx": 0, "deconv_fwd": 0, "conv_fwd": 0}
    for mod, name in ((deconv_kernel, "deconv_dw"),
                      (deconv_kernel, "deconv_dx"),
                      (deconv_kernel, "deconv_fwd"),
                      (conv_kernel, "conv_fwd")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    eng = UniformEngine(device="cpu")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 6, 6, 3)).astype(np.float32))
    w1 = torch.from_numpy(rng.normal(size=(3, 3, 3, 4)).astype(np.float32))
    w2 = torch.from_numpy(rng.normal(size=(3, 3, 4, 2)).astype(np.float32))
    w1.requires_grad_()
    w2.requires_grad_()
    h = tconv.conv(x, w1, 2, 1, activation="relu", engine=eng)
    y = tdeconv.deconv(h, w2, 2, ((0, 1), (0, 1)), engine=eng)
    assert calls == {"deconv_dw": 0, "deconv_dx": 0, "deconv_fwd": 1,
                     "conv_fwd": 1}
    y.square().sum().backward()
    # dw for both layers; dx only for the deconv (x wants no gradient),
    # which runs the conv kernel's wrapper once more
    assert calls == {"deconv_dw": 2, "deconv_dx": 1, "deconv_fwd": 1,
                     "conv_fwd": 2}
    assert w1.grad is not None and w2.grad is not None
    # inference: no Function, no backward state
    with torch.inference_mode():
        tdeconv.deconv(h.detach(), w2, 2, engine=eng)


@pytest.mark.parametrize("op", ["deconv", "conv"])
@pytest.mark.parametrize("want_dx,want_dw",
                         [(True, True), (True, False), (False, True)])
def test_backward_args_build_only_the_requested_launches(monkeypatch, op,
                                                         want_dx, want_dw):
    """The backward builds a launch's operands (the dx weight regroup, the
    dw operand casts) only when that launch follows."""
    regroups = []
    real = common.regroup_for_dx

    def spy(*a, **k):
        regroups.append(a)
        return real(*a, **k)
    monkeypatch.setattr(common, "regroup_for_dx", spy)
    eng = UniformEngine(device="cpu")
    x = torch.randn(2, 5, 6, 4)
    w = torch.randn(3, 3, 2, 6)
    make, out = ((tdeconv.deconv_backward_args, (11, 13))
                 if op == "deconv" else (tconv.conv_backward_args, (2, 2)))
    dy = torch.randn(2, *out, 6)
    dx_args, dw_args = make(x, w, dy, 2, 0, groups=2, engine=eng,
                            dx=want_dx, dw=want_dw)
    assert (dx_args is not None) == want_dx
    assert (dw_args is not None) == want_dw
    assert len(regroups) == int(want_dx)


def test_backward_plans_are_memoized_under_a_backward_key(monkeypatch):
    eng = UniformEngine(device="cpu")
    calls = []
    real = tiling.plan_dw_tiles

    def spy(*a, **k):
        calls.append(a)
        return real(*a, **k)
    monkeypatch.setattr(tiling, "plan_dw_tiles", spy)
    x = torch.randn(2, 6, 6, 4)
    w = torch.randn(3, 3, 4, 4, requires_grad=True)
    for _ in range(2):
        tdeconv.deconv(x, w, 2, engine=eng).sum().backward()
    assert len(calls) == 1
    keys = [k for k in eng.plan_cache if len(k) == 12]
    assert len(keys) == 1 and keys[0][10] is True and keys[0][11] == 72
    assert isinstance(eng.plan_cache[keys[0]], tiling.BackwardPlan)


def test_dw_plans_split_long_reductions_only():
    # DCGAN deconv1 at batch 64: x [64,4,4,1024], dy 512 channels; its
    # output alone fills more than a wave of the 64 x 128 tile
    dcgan = tiling.plan_dw_tiles(1024, 512, 9, 64 * 16)
    assert dcgan.splits == 1 and (dcgan.block_a, dcgan.block_c) == (64, 128)
    tile = tiling.DW_KERNEL_TILES[(64, 128)]
    assert dcgan.blocks >= tiling.SMS * tiling.dw_resident_blocks(tile, 4)
    # V-Net merge4 at batch 4: dy 16 channels over 4.19 M rows, x 32
    merge4 = tiling.plan_dw_tiles(16, 32, 27, 4 * 128 * 128 * 64)
    assert (merge4.block_a, merge4.block_c) == (16, 256)
    assert 10 <= merge4.splits <= 200
    assert merge4.blocks >= 132
    assert merge4.splits * merge4.rows_per_split >= 4 * 128 * 128 * 64
    assert merge4.rows_per_split % tiling.DW_BLOCK_ROWS == 0
    # every instantiated dw tile fits one block's shared memory
    for tile in tiling.DW_KERNEL_TILES.values():
        assert tile.smem_bytes(4) <= tiling.SMEM_BUDGET


def test_backward_refuses_int8_naming_the_quantization_item():
    """int8 activations have no backward, with the reference's message;
    int8 weights do (on their dequantized values, tests/test_torch_quant.py)
    and take no gradient of their own."""
    w = torch.randn(3, 3, 2, 2)
    with pytest.raises(NotImplementedError, match="quantized activations"):
        common.check_float_backward(torch.zeros(1, dtype=torch.int8))
    common.check_float_backward(w)
    dw, dscale = common.fold_scale(w, w.to(torch.int8), torch.ones(2))
    assert dw is None and dscale.shape == (2,)


def test_w_scale_folds_into_dscale(engines):
    """A float ``w_scale`` fused into the forward: dw and dscale match the
    JAX op's (the scale's gradient folded per output channel)."""
    jeng, teng = engines
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 5, 5, 3)).astype(np.float32)
    w = rng.normal(size=(3, 3, 3, 4)).astype(np.float32)
    s = rng.uniform(0.5, 1.5, size=(4,)).astype(np.float32)

    def jloss(x, w, s):
        return jnp.sum(jnp.sin(jconv.conv(x, w, 2, 1, w_scale=s,
                                          engine=jeng)))

    ref = jax.jit(jax.grad(jloss, (0, 1, 2)))(*map(jnp.asarray, (x, w, s)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, w, s)]
    y = tconv.conv(ts[0], ts[1], 2, 1, w_scale=ts[2], engine=teng)
    got = torch.autograd.grad(torch.sin(y).sum(), ts)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-4)
