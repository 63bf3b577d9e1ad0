"""The readers of what the program recorded (``program_spans``): host ms
from its spans, counts from its counters, idle gaps joined to the train
step's phases; None where the program recorded nothing or has no
recorder; and a traced CPU run of a tiny checkout reports them."""

import pytest

from bench_dcnn import harness, program_spans
from bench_dcnn.tests.tiny import result, run_cli, tiny_checkout
from repro_torch import obs

NEW = {"compile_host_ms.infer": "infer", "launch_host_ms.infer": "infer",
       "relayouts_per_batch.infer": "infer",
       "backward_host_ms.train": "train", "update_host_ms.train": "train",
       "backward_idle_share.train": "train",
       "update_idle_share.train": "train"}
MS = 1_000_000


@pytest.fixture
def recorded(monkeypatch):
    """An empty program recorder in the process-wide one's place."""
    tel = obs.Telemetry.create(ring_capacity=64)
    monkeypatch.setattr(obs, "_profiling", tel)
    return tel


def _span(tel, name, a_ms, b_ms, **fields):
    tel.tracer.ring.append({"kind": "span", "name": name, "start_ns":
                            a_ms * MS, "end_ns": b_ms * MS,
                            "duration_s": (b_ms - a_ms) * 1e-3, **fields})


def _ctx(kind, units=2, kernels=(), window_s=0.1):
    return harness.Context(kind=kind, dtype="float32", batch=4, units=units,
                           work=[], window_s=window_s, busy_s=0.05,
                           kernels=list(kernels), host_s={})


def _kernel(a_ms, b_ms):
    return ("igemm_kernel", "kernel", a_ms * MS, b_ms * MS)


@pytest.mark.parametrize("name", sorted(NEW))
def test_an_empty_recorder_reads_none(recorded, name):
    ctx = _ctx(NEW[name], kernels=[_kernel(0, 1), _kernel(2, 3)])
    assert harness.load_metric(name).read(ctx) is None


@pytest.mark.parametrize("name", sorted(NEW))
def test_a_program_without_a_recorder_reads_none(monkeypatch, name):
    monkeypatch.delattr(obs, "profiling_telemetry")
    ctx = _ctx(NEW[name], kernels=[_kernel(0, 1), _kernel(2, 3)])
    assert harness.load_metric(name).read(ctx) is None


def test_host_ms_and_counts_per_unit(recorded):
    _span(recorded, "compile", 0, 1)
    _span(recorded, "compile", 5, 6)
    _span(recorded, "launch", 1, 4)
    _span(recorded, "backward", 10, 13)
    _span(recorded, "update", 13, 14)
    recorded.counter("weight_relayouts_total", op="deconv").inc(6)
    recorded.counter("weight_relayouts_total", op="conv").inc(2)
    infer, train = _ctx("infer"), _ctx("train")
    read = {n: harness.load_metric(n).read for n in NEW}
    assert read["compile_host_ms.infer"](infer) == pytest.approx(1.0)
    assert read["launch_host_ms.infer"](infer) == pytest.approx(1.5)
    assert read["relayouts_per_batch.infer"](infer) == pytest.approx(4.0)
    assert read["backward_host_ms.train"](train) == pytest.approx(1.5)
    assert read["update_host_ms.train"](train) == pytest.approx(0.5)
    # another kind of cell reads nothing
    assert read["compile_host_ms.infer"](train) is None
    assert read["backward_host_ms.train"](infer) is None


def test_each_gap_goes_to_the_phase_open_when_it_began(recorded):
    _span(recorded, "forward", 0, 11)
    _span(recorded, "node", 1, 9)                 # inside forward
    _span(recorded, "loss", 11, 12)
    _span(recorded, "backward", 12, 25)
    _span(recorded, "node_backward", 14, 30)     # the autograd thread's
    _span(recorded, "update", 25, 41)
    kernels = [_kernel(0, 10), _kernel(9, 13), _kernel(15, 20),
               _kernel(30, 40), _kernel(45, 50), _kernel(60, 70)]
    ctx = _ctx("train", kernels=kernels, window_s=0.1)
    # gaps: 13-15 and 20-30 begin in backward; 40-45 begins in update and
    # runs past it; 50-60 begins in no phase (the benchmark's wait)
    assert program_spans.idle_gaps(kernels) == [
        (13 * MS, 15 * MS), (20 * MS, 30 * MS), (40 * MS, 45 * MS),
        (50 * MS, 60 * MS)]
    backward = harness.load_metric("backward_idle_share.train").read(ctx)
    update = harness.load_metric("update_idle_share.train").read(ctx)
    assert backward == pytest.approx(100 * 12e-3 / 0.1)
    assert update == pytest.approx(100 * 5e-3 / 0.1)
    # without kernels there are no gaps to read
    assert harness.load_metric("update_idle_share.train").read(
        _ctx("train")) is None


def test_a_ring_that_dropped_records_reads_none(recorded):
    for i in range(recorded.tracer.capacity + 1):
        _span(recorded, "compile", i, i + 1)
    assert harness.load_metric("compile_host_ms.infer").read(
        _ctx("infer")) is None


def test_a_traced_cpu_run_reports_the_programs_metrics(tmp_path):
    root = tiny_checkout(tmp_path / "co")
    res = result(run_cli(root, "vnet.infer-b8", trace=1))
    assert res["correct"] is True
    got = res["metrics"]
    assert got["relayouts_per_batch.infer"]["value"] == 4.0
    assert got["compile_host_ms.infer"]["value"] > 0
    # the plain versions run on the CPU: nothing is launched
    assert got["launch_host_ms.infer"]["value"] == 0.0
    assert got["relayouts_per_batch.infer"]["unit"] == "relayouts"
