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
"""

from __future__ import annotations

from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    quantile,
)
from repro_torch.obs.trace import Span, Tracer
from repro_torch.obs.report import (
    LayerRuntime,
    RuntimeReport,
    instrument_apply,
    machine_mem_gbps,
    machine_peak_gflops,
    measure_network,
    timed_call,
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

    def span(self, name: str, **fields):
        return self.tracer.span(name, **fields)

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
    "timed_call",
]
