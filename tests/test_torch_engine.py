"""The port's engine against the JAX package's Pallas engine.

``compile_network`` on a small DCGAN chain and a small V-Net graph matches
the reference at 1e-4 (f32) from the same numpy weights and inputs; the
planner runs once per layer geometry; a bf16 graph stays bf16; and a
forward makes exactly one kernel-wrapper call per layer node.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import networks as jnet  # noqa: E402
from repro.core.engine import UniformEngine as JaxEngine  # noqa: E402
from repro.core.engine import compile_network as j_compile  # noqa: E402
from repro_torch.convert import weights_from_numpy  # noqa: E402
from repro_torch.core import networks as tnet  # noqa: E402
from repro_torch.core import tiling  # noqa: E402
from repro_torch.core.engine import (  # noqa: E402
    METHODS,
    EngineConfig,
    EngineError,
    ScheduleError,
    UniformEngine,
    VmemBudgetError,
    compile_network,
    init_network_weights,
)
from repro_torch.kernels.conv import kernel as conv_kernel  # noqa: E402
from repro_torch.kernels.deconv import kernel as deconv_kernel  # noqa: E402

CPU = dict(device="cpu")


def _dcgan_chain(net):
    layers = net.deconv_stack("g", 2, 4, [8, 4, 3])
    return [dataclasses.replace(l, epilogue=net.Epilogue(
        bias=True, activation="tanh" if i == len(layers) - 1 else "relu"))
        for i, l in enumerate(layers)]


def _numpy_weights(layers, seed):
    rng = np.random.default_rng(seed)
    out = []
    for l in layers:
        w = (0.3 * rng.normal(size=l.weight_shape)).astype(np.float32)
        out.append({"w": w, "b": rng.normal(size=(l.cout,)).astype(
            np.float32)} if l.epilogue.bias else w)
    return out


def test_compile_network_chain_matches_pallas_reference():
    j_layers, t_layers = _dcgan_chain(jnet), _dcgan_chain(tnet)
    ws = _numpy_weights(j_layers, seed=0)
    x = np.random.default_rng(1).normal(size=(2, 4, 4, 8)).astype(np.float32)
    j_apply, _ = j_compile(j_layers, JaxEngine(method="pallas"), batch=2)
    ref = np.asarray(j_apply([{k: jnp.asarray(v) for k, v in e.items()}
                              for e in ws], jnp.asarray(x)))
    t_apply, report = compile_network(t_layers, UniformEngine(**CPU),
                                      batch=2)
    got = t_apply(weights_from_numpy(ws, "cpu", network=t_layers),
                  torch.from_numpy(x))
    assert got.shape == ref.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-4)
    assert report.kernel_launches == 2 and report.unique_plans >= 1
    assert "g.deconv2" in report.describe()


def test_compile_network_vnet_graph_matches_pallas_reference():
    kw = dict(in_spatial=(8, 8, 8), chans=(2, 4))
    j_graph, t_graph = jnet.vnet_graph(**kw), tnet.vnet_graph(**kw)
    ws = dict(zip([l.name for l in j_graph.layers],
                  _numpy_weights(j_graph.layers, seed=2)))
    x = np.random.default_rng(3).normal(size=(2, 8, 8, 8, 1)).astype(
        np.float32)
    j_apply, _ = j_compile(j_graph, JaxEngine(method="pallas"), batch=2)
    ref = np.asarray(j_apply({k: jnp.asarray(v) for k, v in ws.items()},
                             jnp.asarray(x)))
    t_apply, report = compile_network(t_graph, UniformEngine(**CPU),
                                      batch=2)
    got = t_apply(weights_from_numpy(ws, "cpu", network=t_graph),
                  torch.from_numpy(x))
    assert got.shape == ref.shape == (2, 8, 8, 8, 2)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-4)
    ops = [r.op for r in report.layers]
    assert ops.count("concat") == 1 and report.kernel_launches == 5


def _spy_planner(monkeypatch):
    calls = []
    real = tiling.plan_uniform_tiles

    def spy(*a, **k):
        calls.append((a, tuple(sorted(k.items()))))
        return real(*a, **k)

    monkeypatch.setattr(tiling, "plan_uniform_tiles", spy)
    return calls


def test_planner_runs_once_per_geometry(monkeypatch):
    calls = _spy_planner(monkeypatch)
    eng = UniformEngine(**CPU)
    x = torch.randn(1, 6, 6, 4)
    w = torch.randn(3, 3, 4, 4)
    eng.deconv(x, w, 2, 1)
    eng.deconv(x, w, 2, 1)                        # repeated call
    assert len(calls) == 1, calls
    eng.deconv(torch.randn(3, 6, 6, 4), w, 2, 1)  # batch is not geometry
    assert len(calls) == 1, calls
    eng.conv(x, w, 2, 1)                          # the conv direction
    eng.conv(x, w, 2, 1)
    assert len(calls) == 2, calls
    eng.deconv(torch.randn(1, 9, 9, 4), w, 2, 1)  # a new geometry
    assert len(calls) == 3, calls
    eng.deconv(x.to(torch.bfloat16), w.to(torch.bfloat16), 2, 1)
    assert len(calls) == 4 and len(eng.plan_cache) == 4


@pytest.mark.parametrize("cin,cout,groups,block_co", [
    (8, 3, 1, 16),
    (8, 32, 1, 32),
    (8, 48, 1, 64),
    (8, 512, 1, 128),                 # past the widest tile: the widest
    (8, 64, 4, 16),                   # per group: 16 channels
])
def test_plans_pick_the_smallest_covering_channel_tile(cin, cout, groups,
                                                       block_co):
    plan = tiling.plan_uniform_tiles(cin, cout, groups=groups)
    assert plan.block_co == block_co
    tile = tiling.KERNEL_TILES[block_co]
    assert (plan.block_m, plan.threads) == (tile.block_m, tile.threads)
    assert plan.step_smem_bytes <= tiling.SMEM_BUDGET


def test_strict_budget_raises_typed():
    eng = UniformEngine(strict_vmem=True, max_tile_bytes=64, **CPU)
    with pytest.raises(VmemBudgetError) as info:
        eng.deconv(torch.randn(1, 4, 4, 2), torch.randn(3, 3, 2, 2), 2)
    assert info.value.plan.overflows
    assert isinstance(info.value, ScheduleError)


def test_bf16_graph_stays_bf16():
    graph = tnet.vnet_graph(in_spatial=(8, 8, 8), chans=(2, 4))
    eng = UniformEngine(**CPU)
    ws = init_network_weights(graph, torch.Generator().manual_seed(0))
    apply, report = compile_network(graph, eng, dtype=torch.bfloat16)
    x = torch.randn(1, 8, 8, 8, 1, generator=torch.Generator().manual_seed(1))
    y16 = apply(ws, x.to(torch.bfloat16))
    y32 = apply(ws, x)
    assert y16.dtype == torch.bfloat16 and y32.dtype == torch.float32
    assert all(r.dtype == "bfloat16" for r in report.layers)
    # five bf16-stored layers: a few bf16 rounding steps of the output scale
    tol = 5e-2 * float(y32.abs().max())
    assert float((y16.float() - y32).abs().max()) <= tol


def _count_wrapper_calls(monkeypatch):
    counts = {"deconv": 0, "conv": 0}
    for op, mod, fn in (("deconv", deconv_kernel, "deconv_fwd"),
                        ("conv", conv_kernel, "conv_fwd")):
        real = getattr(mod, fn)

        def spy(*a, _real=real, _op=op, **k):
            counts[_op] += 1
            return _real(*a, **k)

        monkeypatch.setattr(mod, fn, spy)
    return counts


@pytest.mark.parametrize("chans,spatial,convs,deconvs", [
    ((2, 4), (8, 8, 8), 4, 1),
    ((2, 2, 2, 2, 2), (16, 16, 16), 10, 4),     # the five V-Net stages
])
def test_one_wrapper_call_per_layer_node(monkeypatch, chans, spatial, convs,
                                         deconvs):
    graph = tnet.vnet_graph(in_spatial=spatial, chans=chans)
    ws = init_network_weights(graph, torch.Generator().manual_seed(0))
    apply, report = compile_network(graph, UniformEngine(**CPU))
    counts = _count_wrapper_calls(monkeypatch)
    apply(ws, torch.randn(1, *spatial, 1))
    assert counts == {"conv": convs, "deconv": deconvs}
    assert report.kernel_launches == convs + deconvs


def test_chain_and_graph_errors_are_typed():
    layers = tnet.deconv_stack("g", 2, 4, [4, 4, 2])
    with pytest.raises(ScheduleError):
        compile_network([layers[1], layers[0]], UniformEngine(**CPU))
    apply, _ = compile_network(layers, UniformEngine(**CPU))
    with pytest.raises(ScheduleError):
        apply([torch.zeros(layers[0].weight_shape)], torch.zeros(1, 4, 4, 4))
    biased = [dataclasses.replace(layers[0], epilogue=tnet.Epilogue(
        bias=True))]
    apply, _ = compile_network(biased, UniformEngine(**CPU))
    with pytest.raises(ScheduleError):
        apply([torch.zeros(layers[0].weight_shape)], torch.zeros(1, 4, 4, 4))


def test_every_method_constructs_and_unknown_names_raise():
    for method in METHODS:
        engine = UniformEngine(EngineConfig(method=method, device="cpu"))
        assert engine.config.method == method
        assert engine.config.conv_method == (
            "pallas" if method == "pallas" else "xla")
    with pytest.raises(ValueError):
        EngineConfig(method="nope", device="cpu")
    with pytest.raises(EngineError):
        UniformEngine(method="xla", device="meta")
