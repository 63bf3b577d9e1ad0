"""The port's own spans (``repro_torch.obs``) on the profiler's clock.

A span is stamped with ``time.time_ns`` beside the ``repro_torch.<name>``
range it opens while a ``torch.profiler`` records; with neither a
profiler nor an engine's telemetry a site records nothing and never
enters ``record_function``; under a profiler a reduced V-Net forward
records its compile, its apply, one node span per graph node (parented
on the apply) and one relayout per deconv, and a train step its phases
in order, the ops' backward spans inside ``backward``.  Outside a profile
an engine's own telemetry takes only the compile and apply spans and the
counters, and the process-wide recorder holds the latest profile alone.
"""

import threading

import pytest
import torch

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.core.engine import EngineConfig, UniformEngine
from repro_torch.launch import steps as TS
from repro_torch.models import dcnn as D
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime.dcnn_server import (DcnnServer, ServeRequest,
                                             vnet_spec)

CPU_ONLY = [torch.profiler.ProfilerActivity.CPU]
VNET_NODES = 18         # 5 encoder convs, 4 x (up, skip concat, merge), head
VNET_DECONVS = 4
VNET_LAYERS = 14


@pytest.fixture
def fresh(monkeypatch):
    """A new process-wide profiling recorder for this test alone."""
    monkeypatch.setattr(obs, "_profiling", None)
    return obs.profiling_telemetry


@pytest.fixture(scope="module")
def vnet():
    cfg = get_config("v-net").reduced()
    params = TS.real_params(cfg, torch.Generator().manual_seed(0), "cpu")
    vol = torch.randn((1, *D._vnet_spatial(cfg), 1),
                      generator=torch.Generator().manual_seed(1))
    return cfg, params, vol


def _profile():
    return torch.profiler.profile(activities=CPU_ONLY)


def _warm_engine(cfg, params, vol):
    """An engine whose plans are cached, so a profiled call plans nothing."""
    eng = UniformEngine(device="cpu")
    with torch.inference_mode():
        D.vnet_forward(params["vnet"], cfg, vol, eng)
    return eng


def test_profiler_recording_only_inside_a_profile():
    assert obs.profiler_recording() is False
    with _profile():
        assert obs.profiler_recording() is True
    assert obs.profiler_recording() is False


def test_active_prefers_the_engines_telemetry(fresh):
    tel = obs.Telemetry.create()
    assert obs.active(tel) is tel
    assert obs.active(None) is None
    with _profile():
        assert obs.active(tel) is tel
        assert obs.active(None) is fresh()
    assert obs.active(None) is None


def test_a_span_sits_on_the_profilers_clock():
    tel = obs.Telemetry.create()
    with _profile():                    # the first range's lazy set-up
        with tel.span("warm"):
            pass
    with _profile() as prof:
        with tel.span("probe", "x", shape=(2, 3)) as span:
            torch.ones(64).sum()
    rec = tel.tracer.events("probe")[0]
    assert rec["of"] == "x" and rec["shape"] == (2, 3)
    assert rec["start_ns"] == span.start_ns and rec["end_ns"] == span.end_ns
    assert rec["duration_s"] == pytest.approx(
        (rec["end_ns"] - rec["start_ns"]) * 1e-9, abs=1e-4)
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "repro_torch.probe.x"]
    assert len(events) == 1
    assert abs(events[0].start_ns() - rec["start_ns"]) < 500_000
    assert abs(events[0].end_ns() - rec["end_ns"]) < 500_000


def test_a_span_that_raises_still_records():
    tel = obs.Telemetry.create()
    with pytest.raises(ValueError):
        with tel.span("outer"):
            with tel.span("inner"):
                raise ValueError("boom")
    inner, outer = tel.tracer.events()
    assert inner["name"] == "inner" and inner["error"] == "ValueError"
    assert outer["error"] == "ValueError"
    assert inner["parent"] == outer["id"] and outer["parent"] is None
    with tel.span("after"):             # the thread's stack was unwound
        pass
    assert tel.tracer.events("after")[0]["parent"] is None


def test_parents_are_per_thread():
    tel = obs.Telemetry.create()
    seen = {}

    def other():
        with tel.span("other") as s:
            seen["parent"] = s.parent

    with tel.span("main"):
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    assert seen["parent"] is None


def test_nothing_records_without_a_profiler_or_telemetry(monkeypatch, vnet):
    cfg, params, vol = vnet
    eng = UniformEngine(device="cpu")

    def refuse(*a, **k):
        raise AssertionError("a site entered a recorder")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(obs.trace, "RANGE", refuse)
    monkeypatch.setattr(obs, "profiling_telemetry", refuse)
    monkeypatch.setattr(obs.Tracer, "span", refuse)
    with torch.inference_mode():
        y = D.vnet_forward(params["vnet"], cfg, vol, eng)
    assert y.shape == (*vol.shape[:-1], 2)
    step = TS.make_vnet_train_step(cfg, AdamWConfig(), eng)
    step(params, adamw_init(params, AdamWConfig()), _batch(vol))


def test_a_profiled_forward_records_the_engines_spans(fresh, vnet):
    cfg, params, vol = vnet
    eng = _warm_engine(cfg, params, vol)
    with _profile() as prof:
        with torch.inference_mode():
            D.vnet_forward(params["vnet"], cfg, vol, eng)
    tel = fresh()
    names = [e["name"] for e in tel.tracer.events()]
    assert names.count("compile") == 1 and names.count("apply") == 1
    assert "plan" not in names                   # every plan was cached
    (compile_,) = tel.tracer.events("compile")
    assert compile_["nodes"] == VNET_NODES
    assert compile_["schedule"] == "graph:vnet.head"
    (apply,) = tel.tracer.events("apply")
    nodes = tel.tracer.events("node")
    assert len(nodes) == VNET_NODES
    assert all(n["parent"] == apply["id"] for n in nodes)
    assert {n["op"] for n in nodes} == {"conv", "deconv", "concat"}
    relayouts = tel.tracer.events("relayout")
    assert len(relayouts) == VNET_DECONVS
    assert all(r["of"] == "phase_major_weights" and r["op"] == "deconv"
               for r in relayouts)
    reg = tel.registry
    assert reg.get("weight_relayouts_total", op="deconv").value == 4
    assert reg.get("engine_compiles_total",
                   schedule="graph:vnet.head").value == 1
    ranges = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {"repro_torch.compile", "repro_torch.apply",
            "repro_torch.node.vnet.enc1", "repro_torch.node.vnet.skip1",
            "repro_torch.relayout.phase_major_weights"} <= ranges


def test_a_profiled_train_step_records_its_phases(fresh, vnet):
    cfg, params, vol = vnet
    eng = UniformEngine(device="cpu")
    opt = AdamWConfig()
    step = TS.make_vnet_train_step(cfg, opt, eng)
    state = adamw_init(params, opt)
    step(params, state, _batch(vol))             # plans every geometry
    with _profile():
        step(params, state, _batch(vol))
    tel = fresh()
    phases = [e for e in tel.tracer.events()
              if e["name"] in ("forward", "loss", "backward", "update")]
    assert [p["name"] for p in phases] == ["forward", "loss", "backward",
                                           "update"]
    assert all(p["step"] == 0 and p["parent"] is None for p in phases)
    for a, b in zip(phases, phases[1:]):
        assert a["end_ns"] <= b["start_ns"]
    backward = phases[2]
    node_bw = tel.tracer.events("node_backward")
    assert len(node_bw) == VNET_LAYERS
    # the CPU runs autograd on the calling thread, under ``backward``
    assert all(n["parent"] == backward["id"] for n in node_bw)
    assert {n["of"] for n in node_bw} == {"conv", "deconv"}
    # dx of a deconv: one regroup; of a conv: a regroup and a gather
    bw_relayouts = [r for r in tel.tracer.events("relayout")
                    if backward["start_ns"] <= r["start_ns"]
                    < backward["end_ns"]]
    assert len(bw_relayouts) == VNET_DECONVS + 2 * (
        VNET_LAYERS - VNET_DECONVS) - 2    # enc1's x and no dx
    assert len(tel.tracer.events("node")) == VNET_NODES


def test_profiled_only_inside_a_profile(fresh):
    tel = obs.Telemetry.create()
    assert obs.profiled(tel) is None and obs.profiled(None) is None
    with _profile():
        assert obs.profiled(tel) is tel
        assert obs.profiled(None) is fresh()
    assert obs.profiled(tel) is None


def test_the_engines_telemetry_records_without_a_profiler(vnet):
    """Outside a profile an engine's own recorder (a server's ring) takes
    the compile and apply spans and the counters, and no finer span."""
    cfg, params, vol = vnet
    tel = obs.Telemetry.create()
    eng = UniformEngine(EngineConfig(telemetry=tel, device="cpu"))
    with torch.inference_mode():
        D.vnet_forward(params["vnet"], cfg, vol, eng)
    names = [e["name"] for e in tel.tracer.events()]
    assert sorted(names) == ["apply", "compile"]
    reg = tel.registry
    assert reg.get("weight_relayouts_total", op="deconv").value == \
        VNET_DECONVS
    assert reg.get("engine_plan_cache_misses_total").value == VNET_LAYERS
    assert reg.get("engine_dispatches_total",
                   schedule="graph:vnet.head").value == 1


def test_the_engines_telemetry_takes_the_fine_spans_in_a_profile(fresh,
                                                                  vnet):
    cfg, params, vol = vnet
    tel = obs.Telemetry.create()
    eng = UniformEngine(EngineConfig(telemetry=tel, device="cpu"))
    with torch.inference_mode():
        D.vnet_forward(params["vnet"], cfg, vol, eng)
        with _profile():
            D.vnet_forward(params["vnet"], cfg, vol, eng)
    (apply,) = tel.tracer.events("apply")[1:]
    nodes = tel.tracer.events("node")
    assert len(nodes) == VNET_NODES
    assert all(n["parent"] == apply["id"] for n in nodes)
    assert len(tel.tracer.events("relayout")) == VNET_DECONVS
    # the wrappers know no engine: their launches go to the profile's
    assert not tel.tracer.events("launch")
    assert not fresh().tracer.events("node")


def test_a_new_profile_empties_the_profiling_recorder(fresh, vnet):
    cfg, params, vol = vnet
    eng = _warm_engine(cfg, params, vol)
    with torch.inference_mode():
        for _ in range(2):
            with _profile():
                D.vnet_forward(params["vnet"], cfg, vol, eng)
            D.vnet_forward(params["vnet"], cfg, vol, eng)
    tel = fresh()
    names = [e["name"] for e in tel.tracer.events()]
    assert names.count("apply") == 1 and names.count("node") == VNET_NODES
    assert tel.registry.get("weight_relayouts_total",
                            op="deconv").value == VNET_DECONVS


def test_a_served_batch_records_its_apply_and_dispatch_alone():
    """A server's ring turns over at two records a batch: its own
    ``dispatch`` span and the engine's ``apply`` (one ``compile`` a
    schedule)."""
    srv = DcnnServer([vnet_spec(chans=(2, 4))], device="cpu")
    gen = torch.Generator().manual_seed(3)
    for _ in range(3):
        srv.submit(ServeRequest(
            "vnet", torch.randn((8, 8, 8, 1), generator=gen).numpy()))
        assert all(r.ok for r in srv.drain())
    names = [e["name"] for e in srv.telemetry.tracer.events()]
    assert sorted(names) == ["apply"] * 3 + ["compile"] + ["dispatch"] * 3


def _batch(vol):
    labels = (torch.rand(vol.shape[:-1],
                         generator=torch.Generator().manual_seed(2))
              > 0.5).to(torch.float32)
    return {"vol": vol, "labels": labels}
