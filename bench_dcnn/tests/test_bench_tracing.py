"""The trace's reduction: busy time as the union of the device's
operations, idle gaps labelled by the host's span, annotations left
out."""

import pytest
import torch

from bench_dcnn.tracing import summarize

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    def __init__(self, name, dev, a, b, annotation=False):
        self._v = (name, dev, a, b, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]


def test_busy_gaps_and_labels():
    ms = 1_000_000
    events = [
        Ev("bench.window", CPU, 0, 100 * ms),
        Ev("bench.issue", CPU, 0, 30 * ms),
        Ev("bench.wait", CPU, 30 * ms, 95 * ms),
        Ev("bench.issue", CUDA, 5 * ms, 20 * ms, annotation=True),
        Ev("igemm_bf16_kernel", CUDA, 10 * ms, 40 * ms),
        Ev("igemm_bf16_kernel", CUDA, 35 * ms, 50 * ms),   # overlaps
        Ev("Memcpy DtoD", CUDA, 60 * ms, 70 * ms),
        Ev("dw_kernel", CUDA, 90 * ms, 120 * ms),          # past the end
        Ev("aten::cat", CPU, 1 * ms, 2 * ms),
    ]
    t = summarize(events)
    assert t.window_s == pytest.approx(0.1)
    assert t.busy_s == pytest.approx(0.040 + 0.010 + 0.010)
    assert [o[1] for o in t.ops] == ["kernel", "kernel", "gpu_memcpy",
                                     "kernel"]
    assert len(t.kernels) == 3
    # longest first: 70-90 ms and 50-60 ms in the wait, 0-10 ms in the issue
    assert [g[0] for g in t.gaps] == ["wait", "issue", "wait"] \
        or [g[0] for g in t.gaps] == ["wait", "wait", "issue"]
    assert [g[1] for g in t.gaps] == pytest.approx([0.02, 0.01, 0.01])
    assert t.host_s["issue"] == pytest.approx(0.030)
    assert t.by_name()[0][0] == "igemm_bf16_kernel"
    assert t.by_name()[0][1] == pytest.approx(0.045)
