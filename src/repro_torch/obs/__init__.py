"""repro_torch.obs — the port's telemetry spine.

``Telemetry`` bundles the process-local ``MetricsRegistry`` (typed
Counter/Gauge/Histogram instruments) with a span ``Tracer`` (bounded ring
buffer + optional JSONL event log).  The engine (``EngineConfig(
telemetry=...)``) and the server record into one of these.  ``report``
measures networks node by node against the machine's roofs (the paper's
Fig. 6 table, ``measure_network``) and times instrumented callables
(``instrument_apply``); ``export`` renders a registry as JSON or
Prometheus text.  Instruments are host-side: recording never launches
anything on the card.

The program's own sites find their recorder in one of two ways.  The
engine's ``compile`` and ``apply`` spans and the counters ask
``active(telemetry)``: the engine's ``Telemetry`` where it names one,
else ``profiled(None)``.  The fine sites (each ``node`` of a walk, the
ops' weight ``relayout``, the wrappers' ``launch``, the generator's
``project``, the train step's phases and ``node_backward``) ask
``profiled(telemetry)``: while a ``torch.profiler`` records, the engine's
``Telemetry`` or else the process-wide ``profiling_telemetry()``, and
None otherwise, so an engine's own recorder (a server's ring) takes
about two spans a call outside a profile.  Where a site finds None it
enters the shared no-op ``NO_SPAN`` and does nothing else: an unprofiled
run pays one flag read a site, and a profiled one carries the program's
spans on the profiler's clock (and as ``repro_torch.*`` ranges in its
trace) with no change to the caller.
"""

from __future__ import annotations

import threading

from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    quantile,
)
from repro_torch.obs.trace import NO_SPAN, Span, Tracer, profiler_recording
from repro_torch.obs.report import (
    LayerRuntime,
    RuntimeReport,
    instrument_apply,
    machine_mem_gbps,
    machine_peak_gflops,
    measure_network,
)
from repro_torch.obs.export import (
    registry_to_dict,
    render_json,
    render_prometheus,
)


class Telemetry:
    """The spine: one registry + one tracer, passed by reference.

    Hashes by identity (not by content), so it can ride inside the frozen
    ``EngineConfig`` dataclass.
    """

    def __init__(self, registry: MetricsRegistry | None = None,
                 tracer: Tracer | None = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else Tracer()

    @classmethod
    def create(cls, jsonl_path: str | None = None,
               ring_capacity: int = 2048) -> "Telemetry":
        return cls(MetricsRegistry(),
                   Tracer(capacity=ring_capacity, jsonl_path=jsonl_path))

    def counter(self, name: str, **labels) -> Counter:
        return self.registry.counter(name, **labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self.registry.gauge(name, **labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self.registry.histogram(name, **labels)

    def span(self, name: str, of=None, **fields):
        return self.tracer.span(name, of, **fields)

    def event(self, name: str, **fields) -> None:
        self.tracer.event(name, **fields)

    def flush_metrics(self) -> None:
        """Append every instrument's final snapshot to the tracer's
        ring/JSONL as ``kind="metric"`` records."""
        for inst in self.registry.instruments():
            snap = inst.snapshot()
            snap["instrument"] = snap.pop("kind")
            self.tracer.metric_record(
                inst.name, {"labels": dict(inst.labels), **snap})

    def close(self) -> None:
        self.tracer.close()

    def __repr__(self):
        n = len(self.registry.instruments())
        return (f"Telemetry(instruments={n}, "
                f"events={len(self.tracer.ring)}, "
                f"jsonl={self.tracer.jsonl_path!r})")


__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "LayerRuntime",
    "MetricsRegistry",
    "RuntimeReport",
    "Span",
    "Telemetry",
    "Tracer",
    "instrument_apply",
    "machine_mem_gbps",
    "machine_peak_gflops",
    "measure_network",
    "quantile",
    "registry_to_dict",
    "render_json",
    "render_prometheus",
    "NO_SPAN",
    "active",
    "profiled",
    "profiler_recording",
    "profiling_telemetry",
]


# the profiling recorder's ring: every span of a traced window of seconds
PROFILING_RING = 1 << 20
_profiling: Telemetry | None = None
_profiling_lock = threading.Lock()
# a fine site found no profile running since the recorder last restarted
_unprofiled = False


def profiling_telemetry() -> Telemetry:
    """The process-wide ``Telemetry`` that sites record into while a
    profiler records and their engine names none.  It holds the latest
    profile alone: the first site that finds a profile running after one
    found none empties its ring and its counters (the ring holds
    ``PROFILING_RING`` records)."""
    global _profiling
    if _profiling is None:
        with _profiling_lock:
            if _profiling is None:
                _profiling = Telemetry.create(ring_capacity=PROFILING_RING)
    return _profiling


def profiled(telemetry: Telemetry | None) -> Telemetry | None:
    """Where a fine site records: while a profiler records, ``telemetry``
    (the engine's) when given, else ``profiling_telemetry()``; else
    None."""
    global _unprofiled
    if not profiler_recording():
        _unprofiled = True
        return None
    if telemetry is not None:
        return telemetry
    tel = profiling_telemetry()
    if _unprofiled:
        with _profiling_lock:
            if _unprofiled:
                tel.tracer.clear()
                tel.registry = MetricsRegistry()
                _unprofiled = False
    return tel


def active(telemetry: Telemetry | None) -> Telemetry | None:
    """Where the engine's ``compile`` and ``apply`` spans and the counters
    record: ``telemetry`` (the engine's) when given, else
    ``profiled(None)``."""
    if telemetry is not None:
        return telemetry
    return profiled(None)
