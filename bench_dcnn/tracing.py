"""The benchmark's own spans and the profiler's trace of a window.

With tracing on, ``Tracer.span`` wraps the benchmark's steps (make
input, issue a batch or step, wait for one) in ``record_function``
spans named ``bench.<step>``, and ``torch.profiler`` records the host's
operations and the device's kernels, copies and sets over the window.
``summarize`` reduces the trace to what the per-layer metrics read: the
window's length, the seconds in which the device ran anything (the union
of its operations), each operation, the device's idle gaps labelled by
the benchmark span the host was in when each began, and the host's
seconds inside each span.  With tracing off every span is a no-op."""

from __future__ import annotations

import contextlib
import dataclasses

import torch

PREFIX = "bench."


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    ops: list            # (name, activity, start_ns, end_ns), in the window
    gaps: list           # (label, seconds), longest first
    host_s: dict         # span name -> seconds the host spent in it

    @property
    def kernels(self) -> list:
        return [o for o in self.ops if o[1] == "kernel"]

    def by_name(self) -> list:
        """(name, seconds) of the device's operations, most time first."""
        tot: dict[str, float] = {}
        for name, _, a, b in self.ops:
            tot[name] = tot.get(name, 0.0) + (b - a) * 1e-9
        return sorted(tot.items(), key=lambda kv: -kv[1])


class Tracer:
    def __init__(self, on: bool, device: torch.device):
        self.on = on
        self.device = device
        self.prof = None

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(PREFIX + name)

    def __enter__(self):
        if self.on:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    def summary(self) -> Trace | None:
        if self.prof is None:
            return None
        return summarize(self.prof.profiler.kineto_results.events())


def _activity(ev) -> str | None:
    """``kernel``, ``gpu_memcpy`` or ``gpu_memset`` for the device's own
    operations, None for anything else (the host's, the annotations'
    device-side copies)."""
    if (ev.device_type() == torch.autograd.DeviceType.CPU
            or ev.is_user_annotation()):
        return None
    name = ev.name()
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def summarize(events) -> Trace:
    host = [(e.name()[len(PREFIX):], e.start_ns(), e.end_ns())
            for e in events
            if e.device_type() == torch.autograd.DeviceType.CPU
            and e.name().startswith(PREFIX)]
    windows = [(a, b) for n, a, b in host if n == "window"]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} windows, not 1")
    w0, w1 = windows[0]
    ops = []
    for e in events:
        kind = _activity(e)
        if kind is not None and e.end_ns() > w0 and e.start_ns() < w1:
            ops.append((e.name(), kind, max(e.start_ns(), w0),
                        min(e.end_ns(), w1)))
    ops.sort(key=lambda o: (o[2], o[3]))
    busy, gaps, edge = 0, [], w0
    for _, _, a, b in ops:
        if a > edge:
            gaps.append((edge, a))
        if b > edge:
            busy += b - max(a, edge)
            edge = b
    if w1 > edge:
        gaps.append((edge, w1))
    steps = sorted((a, b, n) for n, a, b in host if n != "window")
    labelled = []
    for a, b in gaps:
        label = "other"
        for s0, s1, n in steps:
            if s0 <= a < s1:
                label = n          # the innermost span that covers it
            elif s0 > a:
                break
        labelled.append((label, (b - a) * 1e-9))
    labelled.sort(key=lambda g: -g[1])
    host_s: dict[str, float] = {}
    for n, a, b in host:
        host_s[n] = host_s.get(n, 0.0) + (b - a) * 1e-9
    return Trace(window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9, ops=ops,
                 gaps=labelled, host_s=host_s)
