"""The port's runtime report (``repro_torch.obs.report``) against the JAX
package's ``repro.obs.report``.

``measure_network`` lists the same rows (names, ops, valid MACs, in
schedule order) as the reference on the same chain and V-Net graph fed
the same numpy weights and input; its rows carry the Hopper schedule's
columns; ``instrument_apply`` passes through, counts dispatches and times
each one as its ``apply`` span's host duration, and a telemetry-free
``compile_network`` returns a callable that records nothing outside a
profile; the peak probes honour their environment overrides.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.core import networks as jnet  # noqa: E402
from repro.core.engine import UniformEngine as JaxEngine  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.convert import weights_from_numpy  # noqa: E402
from repro_torch.core import networks as tnet  # noqa: E402
from repro_torch.core.engine import (  # noqa: E402
    EngineConfig,
    UniformEngine,
    compile_network,
)
from repro_torch.obs import report as treport  # noqa: E402

CPU = dict(device="cpu")


def _chain(net):
    return net.deconv_stack("t", 2, 4, [8, 4, 3])


def _graph(net):
    return net.vnet_graph(in_spatial=(8, 8, 8), chans=(2, 4), cin=1,
                          num_classes=2)


NETS = {"chain": _chain, "graph": _graph}


def _numpy_inputs(layers, in_spatial, cin, seed=0, batch=2):
    rng = np.random.default_rng(seed)
    ws = []
    for l in layers:
        w = (0.3 * rng.normal(size=l.weight_shape)).astype(np.float32)
        ws.append({"w": w, "b": rng.normal(size=(l.cout,)).astype(
            np.float32)} if l.epilogue.bias else w)
    x = rng.normal(size=(batch, *in_spatial, cin)).astype(np.float32)
    return ws, x


def _inputs(kind, net, batch=2):
    network = NETS[kind](net)
    if kind == "graph":
        layers = network.layers
        (sp, cin) = network.in_shape
    else:
        layers = network
        sp, cin = layers[0].in_spatial, layers[0].cin
    ws, x = _numpy_inputs(layers, sp, cin, batch=batch)
    if kind == "graph":
        ws = {l.name: w for l, w in zip(layers, ws)}
    return network, ws, x


@pytest.mark.parametrize("kind", sorted(NETS))
def test_measure_network_rows_match_the_reference(kind):
    jnetwork, jws, x = _inputs(kind, jnet)
    tnetwork, tws, _ = _inputs(kind, tnet)
    jrep = jobs.measure_network(
        jnetwork, JaxEngine(method="xla"),
        {k: jnp.asarray(v) for k, v in jws.items()} if kind == "graph"
        else [jnp.asarray(w) for w in jws], jnp.asarray(x), batch=2,
        repeats=1, peak_gflops=100.0, name=kind)
    trep = obs.measure_network(
        tnetwork, UniformEngine(**CPU),
        weights_from_numpy(tws, "cpu", network=tnetwork),
        torch.from_numpy(x), batch=2, repeats=1, peak_gflops=100.0,
        name=kind)
    assert [(r.name, r.op, r.macs) for r in trep.layers] == \
        [(r.name, r.op, r.macs) for r in jrep.layers]
    assert trep.total_macs == jrep.total_macs > 0
    assert (trep.network, trep.batch, trep.peak_gflops) == (kind, 2, 100.0)


@pytest.mark.parametrize("kind", sorted(NETS))
def test_measure_network_rows_carry_the_schedule(kind):
    network = NETS[kind](tnet)
    eng = UniformEngine(**CPU)
    rpt = obs.measure_network(network, eng, batch=2, repeats=1,
                              peak_gflops=50.0, name=kind)
    _, sched = compile_network(network, eng, batch=2)
    assert [r.name for r in rpt.layers] == [s.name for s in sched.layers]
    for r, s in zip(rpt.layers, sched.layers):
        assert (r.blocks, r.splits, r.smem_bytes) == \
            (s.blocks, s.splits, s.smem_bytes)
        assert r.flops == 2 * r.macs
        assert r.host_s == r.measured_s           # the host clock alone
        if r.op in ("conv", "deconv"):
            assert r.measured_s > 0 and r.macs > 0
            assert r.utilization == pytest.approx(
                r.achieved_gflops / 50.0)
            assert r.modeled_s == pytest.approx(r.flops / 50e9)
    assert rpt.net_wall_s > 0 and rpt.utilization >= 0
    j = json.loads(json.dumps(rpt.to_json()))
    assert j["total_macs"] == rpt.total_macs
    assert [l["name"] for l in j["layers"]] == [r.name for r in rpt.layers]
    assert {"blocks", "splits", "smem_bytes", "host_us"} <= set(
        j["layers"][0])
    assert j["net_host_us"] == round(rpt.net_host_s * 1e6, 2)
    assert "util" in rpt.describe()


def test_measure_network_records_into_telemetry():
    graph = _graph(tnet)
    tel = obs.Telemetry.create()
    rpt = obs.measure_network(graph, UniformEngine(**CPU), repeats=1,
                              peak_gflops=100.0, name="vnet", telemetry=tel)
    assert "concat" in {r.op for r in rpt.layers}
    assert all(r.macs == 0 for r in rpt.layers if r.op == "concat")
    h = tel.registry.get("runtime_layer_seconds", network="vnet",
                         method="pallas")
    assert h is not None and h.count == len(rpt.layers)
    assert tel.registry.get("runtime_utilization_pct", network="vnet",
                            method="pallas") is not None
    assert tel.tracer.events("measure")


def test_measure_network_defaults_are_seeded():
    chain = _chain(tnet)
    eng = UniformEngine(**CPU)
    a = obs.measure_network(chain, eng, repeats=1, peak_gflops=1.0, seed=3)
    b = obs.measure_network(chain, eng, repeats=1, peak_gflops=1.0, seed=3)
    assert [r.macs for r in a.layers] == [r.macs for r in b.layers]


def test_instrumented_apply_passes_through_and_counts():
    chain = _chain(tnet)
    _, ws, x = _inputs("chain", tnet)
    tws = weights_from_numpy(ws, "cpu", network=chain)
    xt = torch.from_numpy(x)
    bare, report = compile_network(chain, UniformEngine(**CPU), batch=2)
    tel = obs.Telemetry.create()
    inst, _ = compile_network(
        chain, UniformEngine(EngineConfig(telemetry=tel, **CPU)), batch=2)
    tag = inst.telemetry_tag
    assert tag.startswith("chain:")
    # the wrapped callable runs the schedule and records nothing
    torch.testing.assert_close(inst.__wrapped__(tws, xt), bare(tws, xt),
                               rtol=0, atol=0)
    assert tel.registry.get("engine_dispatches_total",
                            schedule=tag).value == 0
    for calls in (1, 2, 3):
        torch.testing.assert_close(inst(tws, xt), bare(tws, xt), rtol=0,
                                   atol=0)
        assert tel.registry.get("engine_dispatches_total",
                                schedule=tag).value == calls
        assert tel.registry.get("engine_dispatch_seconds",
                                schedule=tag).count == calls
    # each dispatch is its apply span's host duration, with no wait
    applies = tel.tracer.events("apply")
    assert [a["schedule"] for a in applies] == [tag] * 3
    assert sorted(tel.registry.get("engine_dispatch_seconds",
                                   schedule=tag).samples()) == sorted(
        a["duration_s"] for a in applies)
    assert not hasattr(treport, "_sync_outputs")
    assert tel.registry.get("engine_compiles_total",
                            schedule=tag).value == 1
    (compile_,) = tel.tracer.events("compile")
    assert compile_["schedule"] == tag and compile_["nodes"] == len(chain)
    assert report.kernel_launches == len(chain)


def test_instrumented_apply_is_a_pass_through_while_capturing(monkeypatch):
    chain = _chain(tnet)
    tel = obs.Telemetry.create()
    inst, _ = compile_network(
        chain, UniformEngine(EngineConfig(telemetry=tel, **CPU)))
    _, ws, x = _inputs("chain", tnet, batch=1)
    tws = weights_from_numpy(ws, "cpu", network=chain)
    monkeypatch.setattr(treport, "_capturing", lambda: True)
    inst(tws, torch.from_numpy(x))
    assert tel.registry.get("engine_dispatches_total",
                            schedule=inst.telemetry_tag).value == 0
    assert tel.registry.get("engine_dispatch_seconds",
                            schedule=inst.telemetry_tag).count == 0
    assert not tel.tracer.events("apply")


def test_compile_network_without_telemetry_returns_the_bare_apply(
        monkeypatch):
    assert EngineConfig().telemetry is None

    def refuse(*a, **k):
        raise AssertionError("recorded outside a profile")

    monkeypatch.setattr(obs, "profiling_telemetry", refuse)
    for kind in sorted(NETS):
        fn, _ = compile_network(NETS[kind](tnet), UniformEngine(**CPU))
        assert not hasattr(fn, "telemetry_tag")
        assert not hasattr(fn, "__wrapped__")
        _, ws, x = _inputs(kind, tnet, batch=1)
        fn(weights_from_numpy(ws, "cpu", network=NETS[kind](tnet)),
           torch.from_numpy(x))


def test_peak_env_overrides(monkeypatch):
    monkeypatch.setenv("REPRO_PEAK_GFLOPS", "123.5")
    monkeypatch.setenv("REPRO_MEM_GBPS", "45.25")
    assert obs.machine_peak_gflops() == 123.5
    assert obs.machine_mem_gbps() == 45.25
    # the override also sets measure_network's roof
    rpt = obs.measure_network(_chain(tnet), UniformEngine(**CPU), repeats=1)
    assert rpt.peak_gflops == 123.5
    # and agrees with the reference's override
    assert jobs.machine_peak_gflops() == 123.5
    assert jobs.machine_mem_gbps() == 45.25


def test_host_probes_measure_and_cache(monkeypatch):
    monkeypatch.delenv("REPRO_PEAK_GFLOPS", raising=False)
    monkeypatch.delenv("REPRO_MEM_GBPS", raising=False)
    monkeypatch.setattr(treport, "_PEAK_CACHE", {})
    peak = obs.machine_peak_gflops(device="cpu")
    mem = obs.machine_mem_gbps(device="cpu")
    assert peak > 0 and mem > 0
    assert obs.machine_peak_gflops(device="cpu") == peak      # cached
    assert obs.machine_mem_gbps(device="cpu") == mem
    assert set(treport._PEAK_CACHE) == {("peak", "cpu"), ("mem", "cpu")}


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without a CUDA device")
def test_card_probe_without_a_card_raises(monkeypatch):
    monkeypatch.delenv("REPRO_PEAK_GFLOPS", raising=False)
    monkeypatch.delenv("REPRO_MEM_GBPS", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        obs.machine_peak_gflops()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        obs.machine_mem_gbps()
