"""The TF32 route of the forward kernels, on the CPU.

f32 x int8 (``Precision(weight_quant="int8")``) and bf16 x int8 launches
of the deconv and conv kernels run on the TF32 tensor cores
(``csrc/igemm.cuh::igemm_tf32_kernel``; bf16 x bf16 takes the bf16
route, ``tests/test_torch_bf16_route.py``): the int8 and bf16 operands are
exact in TF32, f32 activations go in as ``hi = rna_tf32(x)`` and ``lo =
rna_tf32(x - hi)``, two ``mma.m16n8k8`` products a k8 step.  The kernel
runs only on the card (``chip_smoke.py``); here: the route's arithmetic
as this file emulates it (TF32 rounding, the split, the tensor cores'
f32 sums truncated toward zero after every product, their worst case;
a k8 step's two products of f32 activations summed from zero and added
to the f32 result rounded to nearest), held against float64 and against
the JAX package's int8-weight kernel (interpret mode) at the reference's
tolerance; which
operand pair takes which route, and what a launch records; and the bank
map of the route's padded weight stage (``tiling.tf32_b_pitch``).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import quant as jq  # noqa: E402
from repro.core.engine import EngineConfig as JaxConfig  # noqa: E402
from repro.core.engine import UniformEngine as JaxEngine  # noqa: E402
from repro_torch.core import tiling  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

F32, BF16, I8 = torch.float32, torch.bfloat16, torch.int8


def _f64(t):
    return t.to(torch.float64)


# -- an emulation of the route's arithmetic (csrc/igemm.cuh) ------------------

# the bits TF32 drops from an f32 (13 of its 23 mantissa bits), and half
# of their weight
_TF32_DROP = (1 << 13) - 1
_TF32_HALF = 1 << 12


def tf32_rna(x):
    """f32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds: half of the dropped
    bits' weight added to the magnitude, then the 13 bits cleared.
    Non-finite values pass unchanged."""
    bits = x.to(F32).contiguous().view(torch.int32)
    out = ((bits + _TF32_HALF) & ~_TF32_DROP).view(F32)
    return torch.where(torch.isfinite(x), out, x.to(F32))


def tf32_split(x):
    """The route's split of f32 activations: ``hi = rna_tf32(x)`` and
    ``lo = rna_tf32(x - hi)`` (``x - hi`` is exact in f32)."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x.to(F32) - hi)


def _f32_toward_zero(v):
    """float64 ``v`` as f32, truncated toward zero."""
    r = v.to(F32)
    over = _f64(r).abs() > v.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def tf32_route_matmul(a, w, passes=2):
    """What the TF32 route computes for ``a @ w`` ([M, K] x [K, N], f32
    out), each product (``mma.m16n8k8``, 8 pairs summed exactly) added to
    the tensor cores' f32 sums truncated toward zero, their worst case.
    One pass (bf16 activations, exact in TF32) multiplies ``hi =
    rna_tf32(a)`` into sums that run the whole reduction; two passes (f32
    activations) run a k8 step's ``hi`` and ``lo`` products from zero and
    add them to the f32 result, rounded to nearest.  ``w`` must be exact
    in TF32 (int8 or bf16 values)."""
    if passes not in (1, 2):
        raise ValueError(f"passes={passes}: the route runs one or two")
    w64 = _f64(w)
    if not torch.equal(_f64(tf32_rna(w.to(F32))), w64):
        raise ValueError("the weights must be exact in TF32")
    parts = tf32_split(a)[:passes]
    out = torch.zeros(a.shape[0], w.shape[1], dtype=F32)
    t = torch.zeros_like(out)
    for k0 in range(0, a.shape[1], 8):
        for part in parts:
            t = _f32_toward_zero(_f64(t) + _f64(part[:, k0:k0 + 8])
                                 @ w64[k0:k0 + 8])
        if passes == 2:
            out, t = out + t, torch.zeros_like(t)
    return out + t


# -- TF32 rounding and the split ----------------------------------------------

@pytest.mark.parametrize("x,want", [
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),           # a tie: away from zero
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 2.0 ** -11 - 2.0 ** -23, 1.0),           # under the tie: down
    (1.0 + 3 * 2.0 ** -11, 1.0 + 2.0 ** -9),        # a tie above an odd
    (2.0 - 2.0 ** -23, 2.0),                        # carries into the exponent
    (3.0 * 2.0 ** -130, 3.0 * 2.0 ** -130),         # subnormal, exact
    (0.0, 0.0),
])
def test_rna_rounds_to_nearest_ties_away(x, want):
    got = tf32_rna(torch.tensor([x], dtype=F32))
    assert float(got[0]) == want
    # every result is exact in TF32: its 13 low mantissa bits are clear
    assert int(got.view(torch.int32)[0]) & 0x1FFF == 0


def test_rna_keeps_non_finite_values():
    x = torch.tensor([math.inf, -math.inf, math.nan], dtype=F32)
    got = tf32_rna(x)
    assert got[0] == math.inf and got[1] == -math.inf
    assert torch.isnan(got[2])


@pytest.mark.parametrize("spread", [0.0, 4.0, 8.0])
def test_split_reconstructs_f32_within_2_pow_minus_21(spread):
    rng = np.random.default_rng(3)
    x = (rng.normal(size=50_000) * np.exp(spread * rng.normal(size=50_000))
         ).astype(np.float32)
    x = torch.from_numpy(x[np.isfinite(x) & (x != 0)])
    hi, lo = tf32_split(x)
    for part in (hi, lo):            # both parts exact in TF32
        assert torch.equal(tf32_rna(part), part)
    rel = ((_f64(hi) + _f64(lo) - _f64(x)).abs() / _f64(x).abs()).max()
    assert float(rel) <= 2.0 ** -21
    # hi alone is TF32's own precision, 2^-11 relative
    assert float(((_f64(hi) - _f64(x)).abs() / _f64(x).abs()).max()) <= \
        2.0 ** -11


# -- the route's sums ---------------------------------------------------------

def _layer_like(depth, rows=256, cols=16, seed=0):
    """Activations and int8 weights of one reduction ``depth`` pairs deep:
    f32 normal activations, per-column absmax int8 weights."""
    rng = np.random.default_rng(seed + depth)
    a = torch.from_numpy(rng.normal(size=(rows, depth)).astype(np.float32))
    w = rng.normal(size=(depth, cols)) / math.sqrt(depth)
    q = np.round(w / (np.abs(w).max(axis=0) / 127.0))
    return a, torch.from_numpy(q.astype(np.float32))


# V-Net merge4 (27 x 32), V-Net enc5 (27 x 128), DCGAN deconv1 (4 x 1024)
@pytest.mark.parametrize("depth", [864, 3456, 4096])
def test_two_passes_hold_f32_accuracy_one_pass_does_not(depth):
    a, w = _layer_like(depth)
    y = _f64(a) @ _f64(w)
    mag = float(y.abs().max())
    two = float((_f64(tf32_route_matmul(a, w, passes=2)) - y)
                .abs().max()) / mag
    one = float((_f64(tf32_route_matmul(a, w, passes=1)) - y)
                .abs().max()) / mag
    assert two <= 2e-5
    assert one > 1e-4
    assert one > 5 * two


def test_one_pass_is_exact_for_bf16_activations():
    """bf16 activations are exact in TF32: one pass leaves only the f32
    sums' rounding, as the FMA route does."""
    a, w = _layer_like(864, rows=64)
    a = a.to(BF16).to(F32)
    y = _f64(a) @ _f64(w)
    got = tf32_route_matmul(a, w, passes=1)
    assert torch.equal(tf32_split(a)[1], torch.zeros_like(a))
    assert float((_f64(got) - y).abs().max()) / float(y.abs().max()) <= 2e-5


def test_route_refuses_weights_not_exact_in_tf32():
    a, w = _layer_like(32, rows=8)
    with pytest.raises(ValueError, match="exact in TF32"):
        tf32_route_matmul(a, w + 2.0 ** -12)
    with pytest.raises(ValueError, match="one or two"):
        tf32_route_matmul(a, w, passes=3)


@pytest.mark.parametrize("cin,cout", [(64, 16), (288, 8)])
def test_route_matches_the_jax_int8_kernel(cin, cout):
    """A 1x1 conv under w:int8 is one matrix product: the route's two
    passes times the per-cout scale agree with the JAX package's int8
    kernel (interpret mode) at the reference's tolerance for single int8
    ops (``rtol=1e-5, atol=2e-5``, ``tests/test_quant.py``)."""
    rng = np.random.default_rng(cin)
    x = rng.normal(size=(2, 6, 5, cin)).astype(np.float32)
    w = (rng.normal(size=(1, 1, cin, cout)) / math.sqrt(cin)).astype(
        np.float32)
    q = jq.quantize_tensor(jnp.asarray(w))
    jeng = JaxEngine(JaxConfig(method="pallas", precision=jq.Precision(
        weight_quant="int8")))
    ref = np.asarray(jeng.conv(jnp.asarray(x), q["w_q"], 1, 0,
                               w_scale=q["scale"]))
    wq = torch.from_numpy(np.array(q["w_q"])).reshape(cin, cout).float()
    scale = torch.from_numpy(np.array(q["scale"])).reshape(cout)
    got = tf32_route_matmul(torch.from_numpy(x).reshape(-1, cin),
                                   wq) * scale
    np.testing.assert_allclose(got.reshape(ref.shape).numpy(), ref,
                               rtol=1e-5, atol=2e-5)


# -- which pair takes which route ---------------------------------------------

@pytest.mark.parametrize("x_bytes,w_bytes,route", [
    (4, 1, "tf32"), (2, 1, "tf32"), (2, 2, "bf16"), (2, None, "bf16"),
    (4, 4, "fma"), (4, None, "fma"), (1, 1, "s8"), (1, None, "s8"),
    (1, 4, "fma"), (8, 8, "fma"),          # no pair the kernels take
])
def test_operand_route_names_each_pair(x_bytes, w_bytes, route):
    assert tiling.operand_route(x_bytes, w_bytes) == route


@pytest.mark.parametrize("x_dtype,w_dtype,kmajor,route", [
    (F32, I8, False, "tf32"), (BF16, I8, False, "tf32"),
    (BF16, BF16, False, "bf16"), (F32, F32, False, "fma"),
    (I8, I8, True, "s8"),
])
def test_forward_route_of_the_wrappers_operands(x_dtype, w_dtype, kmajor,
                                                route):
    x = torch.zeros(1, 2, 2, 2, 16).to(x_dtype)
    w = torch.zeros((1, 1, 16, 16) if kmajor else (27, 16, 16)).to(w_dtype)
    assert build.forward_route(x, w, 27 * 16) == route
    # a launch is recorded by what the C entry reports it launched
    passes = 2 if (x_dtype, w_dtype) == (F32, I8) else 1
    launched = build.launched_buffer()
    with pytest.raises(RuntimeError, match="no launch"):
        build.record_operands({}, x, w, launched)
    launched[0], launched[1] = build.LAUNCHED_ROUTES.index(route), passes
    record = {}
    build.record_operands(record, x, w, launched)
    assert record == {(str(x_dtype)[6:], str(w_dtype)[6:], route, passes): 1}
    # the split workspace holds f32 sums off the s8 route
    work = build.split_workspace(2, 4, "cpu", route)
    assert work.dtype == (torch.int32 if route == "s8" else F32)


# -- the padded weight stage --------------------------------------------------

def _bank_ways(addrs, width):
    """The most distinct 4-byte words one bank serves in one pass of a
    warp's shared load (``width`` bytes a lane: 8-byte loads go in two
    half-warp passes, 16-byte ones in four quarter-warp passes)."""
    passes = {1: 1, 2: 1, 4: 1, 8: 2, 16: 4}[width]
    per, worst = 32 // passes, 1
    for p in range(passes):
        banks = {}
        for a in addrs[p * per:(p + 1) * per]:
            for word in range(a // 4, (a + width - 1) // 4 + 1):
                banks.setdefault(word % 32, set()).add(word)
        worst = max(worst, max(len(v) for v in banks.values()))
    return worst


@pytest.mark.parametrize("x_bytes,w_bytes", [(4, 1), (2, 1), (2, 2)])
@pytest.mark.parametrize("block_co", sorted(tiling.TF32_KERNEL_TILES))
def test_b_fragment_reads_hit_distinct_banks(x_bytes, w_bytes, block_co):
    """A lane (gid = lane / 4, tig = lane % 4) of warp column wn reads the
    NT = warp channels / 8 weights ``wn * WTN + gid * NT ..`` of B rows
    tig and tig + 4 (f32 activations) or 2 tig and 2 tig + 1 (bf16) in
    one load; at ``tf32_b_pitch`` no bank serves two words, where the
    unpadded rows would have conflicts for all but the narrow tiles."""
    tile = tiling.TF32_KERNEL_TILES[block_co]
    wtn = tile.block_co // tile.warps_n          # a warp's channels
    nt = wtn // 8
    row = block_co * w_bytes
    pitch = tiling.tf32_b_pitch(x_bytes, row)
    assert pitch % 16 == 0 and pitch >= row

    def worst(p):
        ways = 1
        for wn in range(tile.warps_n):
            for second in (0, 1):
                addrs = []
                for lane in range(32):
                    gid, tig = lane // 4, lane % 4
                    k = (tig + 4 * second if x_bytes == 4
                         else 2 * tig + second)
                    addrs.append(k * p + (wn * wtn + gid * nt) * w_bytes)
                ways = max(ways, _bank_ways(addrs, nt * w_bytes))
        return ways

    assert worst(pitch) == 1
    if block_co >= 64:
        assert worst(row) > 1
