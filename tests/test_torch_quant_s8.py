"""The int8 x int8 route of the forward kernels, on the CPU.

Under ``Precision(weight_quant="int8", act_quant="int8")`` the deconv and
conv kernels run on the int8 tensor cores, reading their weights K-major
(``common.kmajor_weights``: ``[phases, G, Cout/G, kp]``, each phase's
(tap, channel) pairs contiguous and zero-padded to a multiple of 16
bytes).  Here: that layout holds the phase-major slabs' numbers (padding
zero, structural-zero phases zero), the plain version fed it gives the
bits it gives the first layout and agrees with the JAX package's int8
kernel (interpret mode) on the same numpy inputs at the reference's
tolerance (``rtol=1e-5, atol=2e-5``, ``tests/test_quant.py``'s for single
int8 ops), the ops hand the wrappers the K-major layout, and the wrappers
refuse a reduction whose s32 sums could overflow, the K-major layout
beside any other operand pair and the int8 pair in any other layout.  The
kernel itself runs only on the card (``chip_smoke.py``).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import quant as jq  # noqa: E402
from repro.core.engine import EngineConfig as JaxConfig  # noqa: E402
from repro.core.engine import UniformEngine as JaxEngine  # noqa: E402
from repro_torch import quant as tq  # noqa: E402
from repro_torch.core.engine import EngineConfig, UniformEngine  # noqa
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.conv import kernel as conv_kernel  # noqa: E402
from repro_torch.kernels.conv import ops as conv_ops  # noqa: E402
from repro_torch.kernels.conv import ref as conv_ref  # noqa: E402
from repro_torch.kernels.deconv import kernel as deconv_kernel  # noqa: E402
from repro_torch.kernels.deconv import ops as deconv_ops  # noqa: E402
from repro_torch.kernels.deconv import ref as deconv_ref  # noqa: E402

W8A8 = dict(weight_quant="int8", act_quant="int8")


def _t(a):
    return torch.from_numpy(np.array(a))


# (kernel3, stride3, dilation3, cig, groups, cog)
LAYOUTS = [
    ((3, 3, 3), (2, 2, 2), (1, 1, 1), 16, 1, 16),      # V-Net up layers
    ((3, 1, 3), (2, 1, 2), (1, 1, 1), 6, 2, 5),        # 2D, groups, ragged
    ((3, 3, 3), (2, 2, 2), (2, 1, 1), 4, 1, 3),        # dilation 2
    ((1, 3, 3), (1, 3, 2), (1, 1, 1), 3, 3, 2),        # S > K: empty phases
    ((3, 3, 3), (1, 1, 1), (1, 1, 1), 32, 1, 16),      # the conv's layout
    ((1, 1, 1), (1, 1, 1), (1, 1, 1), 16, 1, 2),       # V-Net's head
]


@pytest.mark.parametrize("kernel,stride,dil,cig,groups,cog", LAYOUTS)
def test_kmajor_layout_holds_the_phase_slabs(kernel, stride, dil, cig,
                                             groups, cog):
    rng = np.random.default_rng(1)
    w3 = _t(rng.integers(-127, 128, (*kernel, cig, groups * cog))
            .astype(np.int8))
    wk = common.kmajor_weights(w3, kernel, stride, dil, groups)
    kp = common.kmajor_pitch(kernel, stride, dil, cig)
    assert wk.dtype == torch.int8 and wk.is_contiguous()
    assert wk.shape == (math.prod(stride), groups, cog, kp)
    assert kp % 16 == 0
    per_phase = common.kmajor_phase_taps(kernel, stride, dil)
    deepest = max(len(t) for t in per_phase)
    assert kp == -(-deepest * cig // 16) * 16
    slabs = common.phase_major_weights(w3, kernel, stride, dil)
    off = 0
    for p, taps in enumerate(per_phase):
        depth = len(taps) * cig
        # row [p, g, c] is the phase slab's column g * cog + c, along K
        slab = slabs[off:off + len(taps)].reshape(depth, groups, cog)
        assert torch.equal(wk[p, :, :, :depth], slab.permute(1, 2, 0))
        assert not wk[p, :, :, depth:].any()          # the zero padding
        off += len(taps)
    assert off == math.prod(kernel)
    assert torch.equal(common.taps_from_kmajor(wk, kernel, stride, dil, cig),
                       slabs)


# (op, rank, spatial, cin, cout, kernel, stride, padding, dilation, groups)
CASES = [
    ("conv", 3, (5, 4, 6), 16, 16, 3, 1, 1, 1, 1),    # 16-byte A copies
    ("conv", 3, (5, 4, 6), 8, 12, 3, 2, 1, 1, 2),     # 4-byte, groups
    ("conv", 3, (4, 5, 3), 1, 16, 3, 1, 1, 1, 1),     # V-Net enc1: Cin 1
    ("conv", 3, (4, 5, 3), 16, 2, 1, 1, 0, 1, 1),     # V-Net head: Co 2
    ("conv", 2, (7, 6), 12, 8, 3, 1, 2, 2, 1),        # dilation 2
    ("deconv", 3, (3, 4, 3), 16, 16, 3, 2, ((0, 1),) * 3, 1, 1),
    ("deconv", 2, (4, 5), 24, 6, 3, 2, ((0, 1),) * 2, 1, 3),
    ("deconv", 2, (4, 3), 8, 8, 3, 2, ((1, 1),) * 2, 2, 1),
]


@pytest.mark.parametrize("op,rank,sp,cin,cout,k,stride,pad,dil,groups",
                         CASES)
def test_plain_fed_kmajor_matches_reference(op, rank, sp, cin, cout, k,
                                            stride, pad, dil, groups,
                                            monkeypatch):
    rng = np.random.default_rng(cin * 7 + cout)
    x = rng.normal(size=(2, *sp, cin)).astype(np.float32)
    w = (0.3 * rng.normal(size=(*(k,) * rank, cin // groups, cout))).astype(
        np.float32)
    b = (0.1 * rng.normal(size=(cout,))).astype(np.float32)
    q = jq.quantize_tensor(jnp.asarray(w))
    kw = dict(dilation=dil, groups=groups, activation="leaky_relu",
              alpha=0.1)
    jeng = JaxEngine(JaxConfig(method="pallas",
                               precision=jq.Precision(**W8A8)))
    ref = np.asarray(getattr(jeng, op)(jnp.asarray(x), q["w_q"], stride,
                                       pad, w_scale=q["scale"],
                                       bias=jnp.asarray(b), **kw))
    # the engine hands the wrapper int8 x and the K-major int8 weights
    mod = deconv_kernel if op == "deconv" else conv_kernel
    seen, real = [], getattr(mod, f"{op}_fwd")

    def spy(x3, wk, **k_):
        seen.append((x3.dtype, wk.dtype, wk.dim()))
        return real(x3, wk, **k_)
    monkeypatch.setattr(mod, f"{op}_fwd", spy)
    teng = UniformEngine(EngineConfig(precision=tq.Precision(**W8A8),
                                      device="cpu"))
    wq, scale = _t(q["w_q"]), _t(q["scale"])
    got = getattr(teng, op)(_t(x), wq, stride, pad, w_scale=scale,
                            bias=_t(b), **kw)
    assert seen == [(torch.int8, torch.int8, 4)]
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=2e-5)
    # the plain version fed the K-major layout gives the bits it gives the
    # first layout (the phase-major slabs, or the conv's reshape)
    sx = tq.absmax_scale(_t(x))
    xq = tq.quantize_q8(_t(x), sx)
    args_fn = (deconv_ops.deconv_kernel_args if op == "deconv"
               else conv_ops.conv_kernel_args)
    x3, wk, kwargs, shape = args_fn(xq, wq, stride, pad, bias=_t(b),
                                    w_scale=scale * sx, engine=teng, **kw)
    assert wk.dim() == 4
    kwargs = {k_: v for k_, v in kwargs.items()
              if k_ not in ("block_co", "split")}
    k3, s3, d3 = kwargs["kernel"], kwargs["stride"], kwargs["dilation"]
    w3 = wq.reshape(*k3, cin // groups, cout)
    if op == "deconv":
        first = common.phase_major_weights(w3, k3, s3, d3)
        plain = deconv_ref.deconv_fwd_plain
    else:
        first = w3.reshape(-1, cin // groups, cout)
        plain = conv_ref.conv_fwd_plain
    from_kmajor = plain(x3, wk, **kwargs)
    assert torch.equal(from_kmajor, plain(x3, first, **kwargs))
    assert torch.equal(from_kmajor.reshape(shape), got)


@pytest.mark.parametrize("op", ["conv", "deconv"])
def test_overflow_guard_message(op):
    """int8 x int8 sums are int32: a reduction deeper than 2^31 / 128^2
    pairs raises, on the CPU as on the card (no silent fallback)."""
    limit = (2 ** 31 - 1) // (128 * 128)
    assert limit == 131071
    build.check_s8_depth(limit)
    with pytest.raises(ValueError, match=(
            r"int8 x int8 reduction of 131072 \(tap, channel\) pairs: sums "
            r"of up to 16384 x 131072 could overflow the kernel's int32 "
            r"accumulators \(at most 131071 pairs\)")):
        build.check_s8_depth(limit + 1)
    # through a wrapper: one tap of 131,072 channels
    cin = limit + 1
    x = torch.ones((1, 1, 1, 1, cin), dtype=torch.int8)
    w3 = torch.ones((1, 1, 1, cin, 1), dtype=torch.int8)
    wk = common.kmajor_weights(w3, (1, 1, 1), (1, 1, 1))
    geo = dict(kernel=(1, 1, 1), stride=(1, 1, 1))
    with pytest.raises(ValueError, match="could overflow"):
        if op == "conv":
            conv_kernel.conv_fwd(x, wk, pad_lo=(0, 0, 0),
                                 out_spatial=(1, 1, 1), **geo)
        else:
            deconv_kernel.deconv_fwd(x, wk, **geo)
    # the float routes sum in f32: no such limit
    y = conv_kernel.conv_fwd(x.float(), w3.reshape(1, cin, 1).float(),
                             pad_lo=(0, 0, 0), out_spatial=(1, 1, 1), **geo)
    assert float(y) == cin


def test_kmajor_weights_are_the_int8_pairs_only_layout():
    x = torch.randn(1, 3, 3, 3, 16)
    wk = common.kmajor_weights(torch.ones((3, 3, 3, 16, 16),
                                          dtype=torch.int8),
                               (3, 3, 3), (1, 1, 1))
    geo = dict(kernel=(3, 3, 3), stride=(1, 1, 1), pad_lo=(1, 1, 1),
               out_spatial=(3, 3, 3))
    with pytest.raises(TypeError, match="K-major"):
        conv_kernel.conv_fwd(x, wk, **geo)
    with pytest.raises(TypeError, match="K-major"):      # int8 x int8, taps
        conv_kernel.conv_fwd(x.to(torch.int8), torch.ones(
            (27, 16, 16), dtype=torch.int8), **geo)
    with pytest.raises(ValueError, match="does not fit"):
        conv_kernel.conv_fwd(x.to(torch.int8), wk[..., :16], **geo)
    y = conv_kernel.conv_fwd(x.to(torch.int8), wk, **geo)
    assert y.dtype == torch.float32 and y.shape == (1, 3, 3, 3, 16)
