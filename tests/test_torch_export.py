"""The port's exporters (``repro_torch.obs.export``) against the JAX
package's ``repro.obs.export``: the same sequence of instrument operations
on both registries renders the same JSON and Prometheus text."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as jobs  # noqa: E402
from repro_torch import obs  # noqa: E402


def _record(registry, seed):
    """One seeded sequence of instrument operations."""
    rng = np.random.default_rng(seed)
    registry.counter("req_total", model="vnet").inc(3)
    registry.counter("req_total", model="dcgan_gen").inc()
    registry.counter("plain_total").inc(2)
    registry.gauge("depth").set(1.0)
    registry.gauge("util_pct", network="vnet", method="pallas").set(
        float(rng.uniform(0, 100)))
    h = registry.histogram("lat_seconds", bucket="vnet/128x128x64")
    for v in rng.exponential(0.01, size=int(rng.integers(5, 40))):
        h.observe(float(v))
    registry.histogram("empty_seconds")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exporters_render_what_the_reference_renders(seed):
    treg, jreg = obs.MetricsRegistry(), jobs.MetricsRegistry()
    _record(treg, seed)
    _record(jreg, seed)
    assert obs.render_prometheus(treg) == jobs.render_prometheus(jreg)
    assert obs.render_json(treg) == jobs.render_json(jreg)
    assert obs.render_json(treg, indent=None) == \
        jobs.render_json(jreg, indent=None)
    assert obs.registry_to_dict(treg) == jobs.registry_to_dict(jreg)


def test_exporters_json_and_prometheus():
    reg = obs.MetricsRegistry()
    reg.counter("req_total", model="vnet").inc(3)
    reg.gauge("depth").set(1.0)
    reg.histogram("lat_seconds").observe_many([0.1, 0.2, 0.3])
    d = json.loads(obs.render_json(reg))
    assert d["req_total"][0]["value"] == 3.0
    assert d["lat_seconds"][0]["count"] == 3
    text = obs.render_prometheus(reg)
    assert "# TYPE req_total counter" in text
    assert 'req_total{model="vnet"} 3.0' in text
    assert "# TYPE lat_seconds summary" in text
    assert 'lat_seconds{quantile="0.5"} 0.2' in text
    assert "lat_seconds_count 3.0" in text


def test_server_registry_exports_after_a_served_batch():
    from repro_torch.runtime.dcnn_server import (
        DcnnServer,
        ServeRequest,
        dcgan_gen_spec,
    )

    srv = DcnnServer([dcgan_gen_spec(chans=(8, 4, 3))], max_batch=2,
                     device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(2):
        srv.submit(ServeRequest("dcgan_gen", rng.standard_normal(
            (4, 4, 8)).astype(np.float32)))
    assert all(r.ok for r in srv.step())
    reg = srv.telemetry.registry
    d = json.loads(obs.render_json(reg))
    assert d["serve_completed_total"][0]["value"] == 2.0
    assert d["engine_dispatches_total"][0]["value"] == 1.0
    text = obs.render_prometheus(reg)
    assert "# TYPE engine_dispatch_seconds summary" in text
    assert "serve_completed_total 2.0" in text
