"""The port's quantized engine paths against the JAX package's.

The int8-weight conv across the reference's 24-case matrix, int8
activations, the planner's weight width, compiled chains and graphs with
quantized entries (kernel calls counted on the wrappers, the int8 weight
reaching the plain version uncopied, the ``precision`` column, per-layer
overrides), ``convert.weights_from_numpy`` of a quantized JAX tree, and
the slice as a whole: a reduced DCGAN generator and a reduced V-Net served
by the port's ``DcnnServer`` on the CPU with quantized weights, held
against the JAX package's ``compile_network`` on the same weights under
``w:int8`` and ``w:int8+a:int8``.  All inputs come from numpy seeds; the
JAX side runs its Pallas kernels in interpret mode.

Tolerances: ``rtol=1e-5, atol=2e-5`` for single int8 ops (the
reference's).  With int8 activations the per-tensor scale is computed by
the same f32 operations on both sides, so the quantized activations agree
bit for bit on the same input and a single op is held at the same
tolerance.  Served networks are held at the f32 serving tolerance, 1e-4:
every layer's activation scale agreed to the bit here, so no value
crossed a rounding tie between the two packages (on the card such flips
are counted, ``chip_smoke.py``).  Against full precision: 5 % of max |y|.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import quant as jq  # noqa: E402
from repro.core import networks as jnet  # noqa: E402
from repro.core.engine import EngineConfig as JaxConfig  # noqa: E402
from repro.core.engine import UniformEngine as JaxEngine  # noqa: E402
from repro.core.engine import compile_network as jcompile  # noqa: E402
from repro.runtime import dcnn_server as jserver  # noqa: E402
from repro_torch import quant as tq  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    WeightShapeError,
    check_weights,
    weights_from_numpy,
)
from repro_torch.core import networks as tnet  # noqa: E402
from repro_torch.core import tiling  # noqa: E402
from repro_torch.core.engine import (  # noqa: E402
    EngineConfig,
    UniformEngine,
    compile_network,
    init_network_weights,
)
from repro_torch.kernels.conv import kernel as conv_kernel  # noqa: E402
from repro_torch.kernels.conv import ref as conv_ref  # noqa: E402
from repro_torch.kernels.deconv import kernel as deconv_kernel  # noqa: E402
from repro_torch.kernels.deconv import ref as deconv_ref  # noqa: E402
from repro_torch.runtime.dcnn_server import (  # noqa: E402
    DcnnServer,
    ServeRequest,
    dcgan_gen_spec,
    pad_to,
    vnet_spec,
)

W8 = dict(weight_quant="int8")
W8A8 = dict(weight_quant="int8", act_quant="int8")
JENG = JaxEngine(JaxConfig(method="pallas"))
TENG = UniformEngine(device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _engines(policy):
    return (JaxEngine(JaxConfig(method="pallas",
                                precision=jq.Precision(**policy))),
            UniformEngine(EngineConfig(precision=tq.Precision(**policy),
                                       device="cpu")))


@pytest.fixture
def wrapper_calls(monkeypatch):
    """Every kernel-wrapper call and every plain-version call, with the
    operand dtypes each received."""
    calls = {"wrapper": [], "plain": []}
    for mod, name, kind in ((deconv_kernel, "deconv_fwd", "wrapper"),
                            (conv_kernel, "conv_fwd", "wrapper"),
                            (deconv_ref, "deconv_fwd_plain", "plain"),
                            (conv_ref, "conv_fwd_plain", "plain")):
        real = getattr(mod, name)

        def spy(x, w, *a, _real=real, _kind=kind, _name=name, **kw):
            calls[_kind].append((_name, x.dtype, w.dtype))
            return _real(x, w, *a, **kw)
        monkeypatch.setattr(mod, name, spy)
    return calls


# ---------------------------------------------------------------------------
# The int8-weight conv across the reference's matrix
# ---------------------------------------------------------------------------

MATRIX = [
    (rank, stride, variant, epi)
    for rank in (2, 3)
    for stride in (1, 2)
    for variant in ("dense", "grouped", "dilated")
    for epi in ("none", "bias_relu")
]


@pytest.mark.parametrize("rank,stride,variant,epi", MATRIX)
def test_int8_weight_conv_matches_reference(rank, stride, variant, epi):
    rng = np.random.default_rng(rank * 10 + stride)
    sp = {2: (6, 5), 3: (5, 4, 4)}[rank]
    groups = 2 if variant == "grouped" else 1
    dil = 2 if variant == "dilated" else 1
    x = rng.normal(size=(2, *sp, 4)).astype(np.float32)
    w = (0.2 * rng.normal(size=(*(3,) * rank, 4 // groups, 8))).astype(
        np.float32)
    b = (0.1 * rng.normal(size=(8,))).astype(np.float32)
    q = jq.quantize_tensor(jnp.asarray(w))
    kw = dict(dilation=dil, groups=groups,
              activation="relu" if epi == "bias_relu" else "none")
    jb = jnp.asarray(b) if epi == "bias_relu" else None
    tb = _t(b) if epi == "bias_relu" else None
    ref = np.asarray(JENG.conv(jnp.asarray(x), q["w_q"], stride, 1,
                               w_scale=q["scale"], bias=jb, **kw))
    wq, scale = _t(q["w_q"]), _t(q["scale"])
    got = TENG.conv(_t(x), wq, stride, 1, w_scale=scale, bias=tb, **kw)
    deq = TENG.conv(_t(x), tq.dequantize_int8(wq, scale), stride, 1,
                    bias=tb, **kw)
    f32 = TENG.conv(_t(x), _t(w), stride, 1, bias=tb, **kw)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), deq.numpy(), rtol=1e-5,
                               atol=2e-5)
    tol = 0.05 * float(f32.abs().max()) + 1e-6
    assert float((got - f32).abs().max()) <= tol


# ---------------------------------------------------------------------------
# int8 activations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["deconv", "conv"])
def test_int8_activations_match_reference(op, wrapper_calls):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 6, 5, 8)).astype(np.float32)
    w = (0.2 * rng.normal(size=(3, 3, 8, 16))).astype(np.float32)
    b = (0.1 * rng.normal(size=(16,))).astype(np.float32)
    q = jq.quantize_tensor(jnp.asarray(w))
    jeng, teng = _engines(W8A8)
    pad = ((0, 1), (0, 1)) if op == "deconv" else 1
    kw = dict(activation="leaky_relu", alpha=0.1)
    ref = getattr(jeng, op)(jnp.asarray(x), q["w_q"], 2, pad,
                            w_scale=q["scale"], bias=jnp.asarray(b), **kw)
    got = getattr(teng, op)(_t(x), _t(q["w_q"]), 2, pad,
                            w_scale=_t(q["scale"]), bias=_t(b), **kw)
    assert got.dtype == torch.float32           # int8 inputs store f32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=2e-5)
    # the wrapper received int8 activations and int8 weights
    assert wrapper_calls["wrapper"] == [(f"{op}_fwd", torch.int8,
                                         torch.int8)]
    f32 = getattr(TENG, op)(_t(x), _t(w), 2, pad, bias=_t(b), **kw)
    assert float((got - f32).abs().max()) <= 0.05 * float(f32.abs().max())


# ---------------------------------------------------------------------------
# Planner: the weight width
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,cin,cout", [("deconv", 64, 64),
                                           ("conv", 16, 16),
                                           ("deconv", 1024, 512)])
def test_int8_weights_shrink_smem_at_identical_blocks(mode, cin, cout):
    p32 = tiling.plan_uniform_tiles(cin, cout, mode=mode, in_dtype_bytes=4)
    p8 = tiling.plan_uniform_tiles(cin, cout, mode=mode, in_dtype_bytes=4,
                                   w_dtype_bytes=1)
    # int8 weights beside f32 activations take the TF32 route's tile: the
    # FMA route's rows, pairs, channels and stages, in warps of its own
    assert (p32.block_m, p32.block_ci, p32.block_co, p32.stages) == \
        (p8.block_m, p8.block_ci, p8.block_co, p8.stages)
    assert p8.threads == tiling.TF32_KERNEL_TILES[p8.block_co].threads
    # the weights' stages at one byte a weight (rows padded), or the f32
    # C tile where it outgrows the rings, whose place it takes after the
    # last stage: the block shrinks either way
    b8 = p8.stages * p8.block_ci * tiling.tf32_b_pitch(4, p8.block_co)
    b32 = p32.stages * p32.block_ci * p32.block_co * 4
    a_ring = p8.stages * p8.block_m * (p8.block_ci * 4 + tiling.A_PAD_BYTES)
    c_tile = p8.block_m * (p8.block_co + 4) * 4
    assert p32.step_smem_bytes - p8.step_smem_bytes == \
        b32 - max(b8, c_tile - a_ring) > 0
    rows, depth = 4 * 16 * 16, 9 * cin
    blocks = tiling.grid_blocks(p32, rows, cout, 1, 4)
    for plan in (p32, p8):      # the same blocks, split at each residency
        assert tiling.grid_blocks(plan, rows, cout, 1, 4) == blocks
        assert tiling.launch_split(plan, rows, depth, cout, 1, 4) == \
            tiling.split_reduction(blocks, depth, tiling.SMS
                                   * tiling.resident_blocks(plan), 4)
    # int8 activations beside int8 weights take the s8 route's tiles: 64
    # pairs a row, B's stage K-major, [block_co][64 + 16] bytes
    pa = tiling.plan_uniform_tiles(cin, cout, mode=mode, in_dtype_bytes=1,
                                   w_dtype_bytes=1)
    tile = tiling.S8_KERNEL_TILES[pa.block_co]
    assert pa.block_ci == 4 * p32.block_ci == tile.k_bytes
    assert (pa.block_m, pa.threads, pa.stages) == (tile.block_m,
                                                   tile.threads, tile.stages)
    assert pa.step_smem_bytes == (
        tile.stages * (tile.block_m * (64 + tiling.A_PAD_BYTES)
                       + tile.block_co * (64 + tiling.B_PAD_BYTES))
        + 16 * tile.block_m + 16 * tiling.MAX_TAPS)


def test_plan_key_grows_weight_width():
    eng = UniformEngine(device="cpu")
    eng.plan("deconv", (4, 1, 4), (3, 1, 3), (2, 1, 2), 8, 8)
    eng.plan("deconv", (4, 1, 4), (3, 1, 3), (2, 1, 2), 8, 8,
             w_dtype_bytes=1)
    keys = sorted(eng.plan_cache)
    assert len(keys) == 2 and {k[-1] for k in keys} == {1, 4}
    assert len({len(k) for k in keys}) == 1


def test_strict_budget_accepts_the_int8_weight_plan():
    p32 = tiling.plan_uniform_tiles(64, 64, mode="deconv")
    p8 = tiling.plan_uniform_tiles(64, 64, mode="deconv", w_dtype_bytes=1)
    budget = (p8.step_smem_bytes + p32.step_smem_bytes) // 2
    eng = UniformEngine(EngineConfig(strict_vmem=True, max_tile_bytes=budget,
                                     device="cpu"))
    assert not eng.plan("deconv", (4, 1, 4), (3, 1, 3), (2, 1, 2), 64, 64,
                        w_dtype_bytes=1).overflows
    with pytest.raises(Exception, match="budget"):
        eng.plan("deconv", (4, 1, 4), (3, 1, 3), (2, 1, 2), 64, 64)


# ---------------------------------------------------------------------------
# Compiled networks
# ---------------------------------------------------------------------------

def _chain():
    layers = tnet.deconv_stack("g", 2, 4, [8, 8, 4])
    ws = init_network_weights(layers, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(1, 4, 4, 8)).astype(np.float32))
    return layers, ws, x


def test_compiled_chain_quantized_launches_and_report(wrapper_calls):
    layers, ws, x = _chain()
    wq = tq.quantize_weights(ws, tq.Precision(**W8))
    eng_q = UniformEngine(EngineConfig(precision=tq.Precision(**W8),
                                       device="cpu"))
    apply_q, rep_q = compile_network(layers, eng_q)
    apply_f, rep_f = compile_network(layers, TENG)
    assert rep_q.kernel_launches == rep_f.kernel_launches == 2
    assert rep_q.blocks == rep_f.blocks
    for rq, rf in zip(rep_q.layers, rep_f.layers):
        assert rq.smem_bytes < rf.smem_bytes
        assert rq.precision == "w:int8" and rf.precision == "f32"
        assert "pr:w:int8" in rq.describe()
    y_q = apply_q(wq, x)
    n_q = list(wrapper_calls["wrapper"])
    y_f = apply_f(ws, x)
    n_f = wrapper_calls["wrapper"][len(n_q):]
    # the same kernel calls, the int8 weights uncopied into the plain
    # version
    assert [c[0] for c in n_q] == [c[0] for c in n_f] == ["deconv_fwd"] * 2
    assert all(c[2] == torch.int8 for c in n_q)
    assert all(c[2] == torch.int8
               for c in wrapper_calls["plain"][:len(n_q)])
    tol = 0.05 * float(y_f.abs().max()) + 1e-6
    assert float((y_q - y_f).abs().max()) <= tol
    # the same chain on the JAX engine, the same quantized weights
    jws = [{k: jnp.asarray(v.numpy()) for k, v in e.items()} for e in wq]
    japply, _ = jcompile(jnet.deconv_stack("g", 2, 4, [8, 8, 4]),
                         JaxEngine(JaxConfig(method="pallas",
                                             precision=jq.Precision(**W8))))
    ref = np.asarray(japply(jws, jnp.asarray(x.numpy())))
    np.testing.assert_allclose(y_q.numpy(), ref, rtol=1e-5, atol=2e-5)


def test_compiled_graph_quantized_with_bias_epilogues(wrapper_calls):
    relu = tnet.Epilogue(bias=True, activation="relu")
    layers = [dataclasses.replace(l, epilogue=relu)
              for l in tnet.deconv_stack("g", 2, 4, [6, 6, 4])]
    graph = tnet.chain_graph(layers)
    ws = init_network_weights(graph, torch.Generator().manual_seed(1))
    for e in ws.values():
        e["b"] = 0.1 * torch.randn(e["b"].shape,
                                   generator=torch.Generator().manual_seed(2))
    wq = tq.quantize_weights(ws, tq.Precision(**W8A8))
    eng = UniformEngine(EngineConfig(precision=tq.Precision(**W8A8),
                                     device="cpu"))
    apply, report = compile_network(graph, eng)
    x = torch.from_numpy(np.random.default_rng(7).normal(
        size=(1, 4, 4, 6)).astype(np.float32))
    y_q = apply(wq, x)
    y_f = compile_network(graph, TENG)[0](ws, x)
    assert all(r.precision == "w:int8+a:int8" for r in report.layers
               if r.plan is not None)
    # every launch took int8 activations and int8 weights
    assert wrapper_calls["wrapper"][:2] == [
        ("deconv_fwd", torch.int8, torch.int8)] * 2
    assert y_q.dtype == torch.float32
    tol = 0.05 * float(y_f.abs().max()) + 1e-6
    assert float((y_q - y_f).abs().max()) <= tol


def test_per_layer_precision_override(wrapper_calls):
    # body int8 weights, head int8 weights and activations; a full-
    # precision head plans at the float width
    layers, ws, x = _chain()
    eng = UniformEngine(EngineConfig(precision=tq.Precision(**W8),
                                     device="cpu"))
    head_f = layers[:-1] + [dataclasses.replace(layers[-1],
                                                precision=tq.Precision())]
    _, report = compile_network(head_f, eng)
    assert [r.precision for r in report.layers] == ["w:int8", "f32"]
    assert report.layers[0].smem_bytes < report.layers[1].smem_bytes
    head_a = layers[:-1] + [dataclasses.replace(
        layers[-1], precision=tq.Precision(**W8A8))]
    apply, report = compile_network(head_a, eng)
    assert [r.precision for r in report.layers] == ["w:int8",
                                                    "w:int8+a:int8"]
    apply(tq.quantize_weights(ws, tq.Precision(**W8)), x)
    assert [c[1] for c in wrapper_calls["wrapper"]] == [torch.float32,
                                                        torch.int8]


# ---------------------------------------------------------------------------
# convert: a quantized tree from the JAX package
# ---------------------------------------------------------------------------

def test_weights_from_numpy_keeps_int8_and_f32_scales():
    spec = jserver.vnet_spec(chans=(2, 4))
    tree = jax.tree_util.tree_map(np.asarray, jq.quantize_weights(
        dict(spec.weights), jq.Precision(**W8)))
    graph = vnet_spec(chans=(2, 4)).graph_for(None)
    ws = weights_from_numpy(tree, "cpu", torch.bfloat16, network=graph)
    for name, e in ws.items():
        assert e["w_q"].dtype == torch.int8, name
        assert e["scale"].dtype == torch.float32, name
        if "b" in e:
            assert e["b"].dtype == torch.bfloat16, name
        np.testing.assert_array_equal(e["w_q"].numpy(), tree[name]["w_q"])
    check_weights(graph, ws)
    name = graph.layers[0].name
    bad = dict(tree, **{name: dict(tree[name],
                                   w_q=tree[name]["w_q"][..., :1])})
    with pytest.raises(WeightShapeError):
        weights_from_numpy(bad, "cpu", network=graph)
    bad = dict(tree, **{name: dict(tree[name],
                                   scale=tree[name]["scale"][:1].repeat(3))})
    with pytest.raises(WeightShapeError, match="scale"):
        weights_from_numpy(bad, "cpu", network=graph)


# ---------------------------------------------------------------------------
# The slice as a whole: quantized serving on the CPU against JAX
# ---------------------------------------------------------------------------

GEN_KW = dict(chans=(8, 4, 3))
VOL_KW = dict(chans=(2, 4))


@pytest.fixture(scope="module")
def jax_specs():
    return jserver.dcgan_gen_spec(**GEN_KW), jserver.vnet_spec(**VOL_KW)


@pytest.mark.parametrize("policy", [W8, W8A8], ids=["w8", "w8a8"])
def test_quantized_serving_matches_reference(jax_specs, policy):
    rng = np.random.default_rng(8)
    reqs = [("dcgan_gen", rng.normal(size=(4, 4, 8)).astype(np.float32)),
            ("vnet", rng.normal(size=(8, 8, 8, 1)).astype(np.float32)),
            ("vnet", rng.normal(size=(6, 7, 5, 1)).astype(np.float32))]
    jeng = JaxEngine(JaxConfig(method="pallas",
                               precision=jq.Precision(**policy)))
    jq_ws, specs = {}, []
    for jspec, make, kw in ((jax_specs[0], dcgan_gen_spec, GEN_KW),
                            (jax_specs[1], vnet_spec, VOL_KW)):
        jws = jq.quantize_weights(dict(jspec.weights),
                                  jq.Precision(**policy))
        jq_ws[jspec.name] = jws
        net = make(**kw).graph_for(None)
        specs.append(make(weights=weights_from_numpy(
            jax.tree_util.tree_map(np.asarray, jws), "cpu", network=net),
            **kw))
    eng = UniformEngine(EngineConfig(precision=tq.Precision(**policy),
                                     strict_vmem=True, device="cpu"))
    srv = DcnnServer(specs, engine=eng, max_batch=2)
    for model, x in reqs:
        srv.submit(ServeRequest(model, x))
    got = {r.id: r for r in srv.drain()}
    assert sorted(got) == [0, 1, 2] and all(r.ok for r in got.values())
    # the reference runs each batch the server formed (both volumes share
    # the 8x8x8 bucket): with int8 activations the scale is per tensor,
    # over the whole batch, so a request's output depends on its batch
    for k, model in enumerate(("dcgan_gen", "vnet")):
        idx = [i for i, (m, _) in enumerate(reqs) if m == model]
        bsp = specs[k].bucket_spatial(tuple(reqs[idx[-1]][1].shape[:-1]))
        xb = jnp.asarray(np.stack([pad_to(reqs[i][1], bsp) for i in idx]))
        graph = jax_specs[k].graph_for(bsp)
        ref = np.asarray(jcompile(graph, jeng, batch=len(idx))[0](
            jq_ws[model], xb))
        # against the full-precision model: the reference's 5 %
        full = np.asarray(jcompile(graph, JENG, batch=len(idx))[0](
            dict(jax_specs[k].weights), xb))
        for row, i in enumerate(idx):
            out = got[i].output
            crop = (row,) + tuple(slice(0, d) for d in out.shape)
            np.testing.assert_allclose(out, ref[crop], rtol=1e-4, atol=1e-4)
            assert np.abs(out - full[crop]).max() <= \
                0.05 * np.abs(full[crop]).max() + 1e-6
