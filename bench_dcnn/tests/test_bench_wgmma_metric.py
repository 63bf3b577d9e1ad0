"""``wgmma_launches_per_batch.infer``: the program's
``wgmma_launches_total`` a batch; nothing where the program recorded no
such counter (a program without kernel 1's wgmma route, the CPU's plain
versions), so that such a run's line leaves the metric out."""

import pytest

from bench_dcnn import harness
from bench_dcnn.tests.tiny import result, run_cli, tiny_checkout
from repro_torch import obs

NAME = "wgmma_launches_per_batch.infer"


@pytest.fixture
def recorded(monkeypatch):
    """An empty program recorder in the process-wide one's place."""
    tel = obs.Telemetry.create(ring_capacity=64)
    monkeypatch.setattr(obs, "_profiling", tel)
    return tel


def _ctx(kind, units=2):
    return harness.Context(kind=kind, dtype="bfloat16", batch=4, units=units,
                           work=[], window_s=0.1, busy_s=0.05, kernels=[],
                           host_s={})


def _span(tel):
    tel.tracer.ring.append({"kind": "span", "name": "launch", "start_ns": 0,
                            "end_ns": 1000, "duration_s": 1e-6})


def test_launches_a_batch(recorded):
    _span(recorded)
    recorded.counter("wgmma_launches_total", op="deconv").inc(6)
    read = harness.load_metric(NAME).read
    assert read(_ctx("infer")) == pytest.approx(3.0)
    assert read(_ctx("train")) is None
    assert read(_ctx("infer", units=0)) is None


def test_no_counter_reads_none(recorded):
    _span(recorded)
    recorded.counter("weight_relayouts_total", op="deconv").inc(4)
    assert harness.load_metric(NAME).read(_ctx("infer")) is None


def test_no_recorder_reads_none(monkeypatch):
    monkeypatch.delattr(obs, "profiling_telemetry")
    assert harness.load_metric(NAME).read(_ctx("infer")) is None


def test_a_traced_cpu_run_leaves_it_out(tmp_path):
    """The plain versions launch nothing: the line has no such metric, and
    the run is correct."""
    root = tiny_checkout(tmp_path / "co")
    res = result(run_cli(root, "dcgan.gen-b1024", trace=1))
    assert res["correct"] is True
    assert NAME not in res["metrics"]
    assert "relayouts_per_batch.infer" in res["metrics"]
