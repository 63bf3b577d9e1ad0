"""Render a ``MetricsRegistry`` as JSON or Prometheus text exposition
(the JAX package's ``obs/export.py``).

Prometheus histograms are exported in summary form (quantile-labelled
series plus ``_sum``/``_count``) because the reservoir keeps raw samples,
not fixed buckets — the natural mapping for p50/p95/p99.
"""

from __future__ import annotations

import json

from repro_torch.obs.metrics import MetricsRegistry


def registry_to_dict(registry: MetricsRegistry) -> dict:
    """Nested plain-dict snapshot: ``{name: [{labels, ...snapshot}]}``."""
    out: dict = {}
    for inst in registry.instruments():
        out.setdefault(inst.name, []).append(
            {"labels": dict(inst.labels), **inst.snapshot()})
    return out


def render_json(registry: MetricsRegistry, indent: int | None = 2) -> str:
    return json.dumps(registry_to_dict(registry), indent=indent,
                      sort_keys=True, default=str)


def _label_str(labels, extra: dict | None = None) -> str:
    pairs = list(labels) + sorted((extra or {}).items())
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in pairs) + "}"


def _fmt(v) -> str:
    if v is None:
        return "NaN"
    return repr(float(v))


def render_prometheus(registry: MetricsRegistry) -> str:
    """Prometheus text exposition format (version 0.0.4)."""
    by_name: dict = {}
    for inst in registry.instruments():
        by_name.setdefault(inst.name, []).append(inst)
    lines: list[str] = []
    for name in sorted(by_name):
        insts = by_name[name]
        kind = insts[0].kind
        prom_type = {"counter": "counter", "gauge": "gauge",
                     "histogram": "summary"}[kind]
        lines.append(f"# TYPE {name} {prom_type}")
        for inst in insts:
            if kind == "histogram":
                snap = inst.snapshot()
                for q, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
                    lines.append(
                        f"{name}{_label_str(inst.labels, {'quantile': q})} "
                        f"{_fmt(snap[key])}")
                lines.append(
                    f"{name}_sum{_label_str(inst.labels)} "
                    f"{_fmt(snap['sum'])}")
                lines.append(
                    f"{name}_count{_label_str(inst.labels)} "
                    f"{_fmt(snap['count'])}")
            else:
                lines.append(
                    f"{name}{_label_str(inst.labels)} {_fmt(inst.value)}")
    return "\n".join(lines) + "\n"
