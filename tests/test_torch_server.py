"""The port's DCNN server on the CPU, against the JAX package's server.

Served outputs (bucket padding, batch padding and crop included) match
what the JAX ``DcnnServer`` serves for the same requests at 1e-4 in f32,
with the JAX specs' weights carried across by ``weights_from_numpy``.  The
rest mirrors the non-fallback behaviours of ``tests/test_dcnn_server.py``:
typed validation, queue shedding, typed deadline expiry, bucketing and
schedule reuse, LRU eviction, retry with backoff, NaN quarantine, and a
typed ``DispatchFailedError`` where the JAX server would fall back.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.runtime import dcnn_server as jserver  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    WeightShapeError,
    weights_from_numpy,
)
from repro_torch.runtime.dcnn_server import (  # noqa: E402
    DcnnServer,
    ServeRequest,
    dcgan_gen_spec,
    pad_to,
    vnet_spec,
)
from repro_torch.runtime.serving import (  # noqa: E402
    Backoff,
    DeadlineExceededError,
    DispatchFailedError,
    InvalidRequestError,
    PoisonedOutputError,
    QueueFullError,
)

RNG = np.random.default_rng(0)
GEN_KW = dict(chans=(8, 4, 3))
VOL_KW = dict(chans=(2, 4))


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


def _vol(sp=(8, 8, 8), cin=1):
    return RNG.normal(size=(*sp, cin)).astype(np.float32)


def _seed(sp=(4, 4), cin=8):
    return RNG.normal(size=(*sp, cin)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_specs():
    return jserver.dcgan_gen_spec(**GEN_KW), jserver.vnet_spec(**VOL_KW)


@pytest.fixture(scope="module")
def specs(jax_specs):
    """The port's specs carrying the JAX specs' weights."""
    jgen, jvol = jax_specs
    gen = dcgan_gen_spec(**GEN_KW)
    vol = vnet_spec(**VOL_KW)

    def carried(jspec, spec):
        tree = jax.tree_util.tree_map(np.asarray, dict(jspec.weights))
        return weights_from_numpy(tree, "cpu",
                                  network=spec.graph_for(None))

    return (dcgan_gen_spec(weights=carried(jgen, gen), **GEN_KW),
            vnet_spec(weights=carried(jvol, vol), **VOL_KW))


def _server(specs, **kw):
    return DcnnServer(list(specs), device="cpu", **kw)


def test_served_outputs_match_jax_server(jax_specs, specs):
    reqs = [("dcgan_gen", _seed()), ("vnet", _vol((8, 8, 8))),
            ("vnet", _vol((6, 7, 5)))]
    jsrv = jserver.DcnnServer(list(jax_specs), max_batch=2)
    tsrv = _server(specs, max_batch=2)
    for model, x in reqs:
        jsrv.submit(jserver.ServeRequest(model, x))
        tsrv.submit(ServeRequest(model, x))
    ref = {r.id: r for r in jsrv.drain()}
    got = {r.id: r for r in tsrv.drain()}
    assert all(r.ok and r.engine == "pallas" for r in ref.values())
    assert all(r.ok and r.engine == "pallas" for r in got.values())
    assert sorted(got) == sorted(ref) == [0, 1, 2]
    assert got[2].output.shape == (6, 7, 5, 2)
    for i in got:
        assert got[i].output.shape == ref[i].output.shape
        np.testing.assert_allclose(got[i].output, ref[i].output,
                                   atol=1e-4, rtol=1e-4)
    assert tsrv.stats()["buckets"].keys() == {"dcgan_gen/4x4/b1",
                                              "vnet/8x8x8/b2"}


def test_submit_validation_typed(specs):
    srv = _server(specs)
    with pytest.raises(InvalidRequestError):
        srv.submit(ServeRequest("nope", _seed()))
    with pytest.raises(InvalidRequestError):        # wrong rank
        srv.submit(ServeRequest("vnet", _seed()))
    with pytest.raises(InvalidRequestError):        # wrong cin
        srv.submit(ServeRequest("vnet", _vol(cin=3)))
    with pytest.raises(InvalidRequestError):        # fixed-geometry model
        srv.submit(ServeRequest("dcgan_gen", _seed(sp=(8, 8))))
    with pytest.raises(InvalidRequestError):        # past the ceiling
        srv.submit(ServeRequest("vnet", _vol((80, 8, 8))))
    s = srv.stats()
    assert s["rejected"] == 5 and s["submitted"] == 0


def test_queue_full_sheds_typed(specs):
    srv = _server(specs, max_queue=2)
    srv.submit(ServeRequest("dcgan_gen", _seed()))
    srv.submit(ServeRequest("dcgan_gen", _seed()))
    with pytest.raises(QueueFullError):
        srv.submit(ServeRequest("dcgan_gen", _seed()))
    s = srv.stats()
    assert s["shed"] == 1 and s["queue_depth"] == 2


def test_deadline_expiry_is_typed_never_dropped(specs):
    clk = FakeClock()
    srv = _server(specs, clock=clk)
    ok_id = srv.submit(ServeRequest("dcgan_gen", _seed()))
    late_id = srv.submit(ServeRequest("dcgan_gen", _seed(), deadline_s=0.5))
    clk.advance(1.0)
    by_id = {r.id: r for r in srv.drain()}
    assert set(by_id) == {ok_id, late_id}
    assert by_id[ok_id].ok
    assert isinstance(by_id[late_id].error, DeadlineExceededError)
    assert by_id[late_id].code == "deadline_exceeded"
    assert srv.stats()["expired"] == 1


def test_shape_bucketing_and_schedule_reuse(specs):
    srv = _server(specs, max_batch=2)
    for sp in [(8, 8, 8), (6, 7, 5), (8, 6, 8)]:    # all bucket to 8x8x8
        srv.submit(ServeRequest("vnet", _vol(sp)))
    res = srv.drain()
    assert all(r.ok for r in res)
    assert {r.id: r.output.shape for r in res}[1] == (6, 7, 5, 2)
    s = srv.stats()
    # 3 requests, max_batch=2 -> buckets b2 + b1: exactly two compiles
    assert s["schedule_cache"]["misses"] == 2
    assert set(s["buckets"]) == {"vnet/8x8x8/b2", "vnet/8x8x8/b1"}
    srv.submit(ServeRequest("vnet", _vol()))
    assert srv.drain()[0].ok
    assert srv.stats()["schedule_cache"]["hits"] == 1


def test_bucket_padding_matches_an_unpadded_run(specs):
    """A request padded into a larger bucket crops back to the output of
    the padded volume's own run."""
    srv = _server(specs)
    x = _vol((6, 7, 5))
    srv.submit(ServeRequest("vnet", x))
    got = srv.drain()[0].output
    srv2 = _server(specs)
    srv2.submit(ServeRequest("vnet", pad_to(x, (8, 8, 8))))
    ref = srv2.drain()[0].output
    np.testing.assert_array_equal(got, ref[:6, :7, :5])


def test_schedule_lru_eviction(specs):
    srv = _server(specs, max_schedules=1, max_batch=1)
    for _ in range(2):
        srv.submit(ServeRequest("dcgan_gen", _seed()))
        assert all(r.ok for r in srv.drain())
        srv.submit(ServeRequest("vnet", _vol()))
        assert all(r.ok for r in srv.drain())
    s = srv.stats()["schedule_cache"]
    assert s["size"] == 1 and s["capacity"] == 1
    assert s["evictions"] >= 3 and s["misses"] >= 4


def test_transient_dispatch_error_retries(specs, monkeypatch):
    sleeps = []
    srv = _server(specs, backoff=Backoff(base_s=0.01, sleep=sleeps.append))
    real = srv._schedule
    failures = [RuntimeError("transient")]

    def flaky(*a):
        fn = real(*a)

        def run(ws, x):
            if failures:
                raise failures.pop()
            return fn(ws, x)
        return run

    monkeypatch.setattr(srv, "_schedule", flaky)
    srv.submit(ServeRequest("dcgan_gen", _seed()))
    res = srv.drain()
    assert res[0].ok and srv.stats()["retries"] == 1
    assert sleeps == pytest.approx([0.01])


def test_failed_schedule_completes_typed(specs):
    """Where the JAX server would fall back to a second engine, the port
    completes the batch with a typed DispatchFailedError."""
    srv = _server(specs, max_tile_bytes=64)       # no plan fits 64 bytes
    srv.submit(ServeRequest("dcgan_gen", _seed()))
    res = srv.drain()
    assert not res[0].ok and res[0].code == "dispatch_failed"
    assert isinstance(res[0].error, DispatchFailedError)
    assert "VmemBudgetError" in str(res[0].error)
    assert srv.stats()["dispatch_failures"] == 1 and srv.health()["ok"]


def test_nan_quarantine_reruns_clean_rows(specs):
    srv = _server(specs, max_batch=4)
    poisoned = _vol()
    poisoned[0, 0, 0, 0] = np.nan
    for x in (poisoned, _vol(), _vol()):
        srv.submit(ServeRequest("vnet", x))
    res = {r.id: r for r in srv.drain()}
    assert res[0].code == "poisoned_output"
    assert isinstance(res[0].error, PoisonedOutputError)
    assert res[1].ok and res[2].ok
    assert np.isfinite(res[1].output).all()
    s = srv.stats()
    assert s["quarantined"] == 1 and s["reruns"] == 1


def test_nan_every_rerun_terminates_typed(specs, monkeypatch):
    """Row 0 of every run comes back NaN: each re-run quarantines its
    poisoned row, and after the second re-run the rows still clean give
    up with the reference's "batch poisoned on every re-run"."""
    srv = _server(specs, max_batch=4)
    real = srv._schedule

    def poisoning(model, bsp, batch):
        fn = real(model, bsp, batch)

        def run(ws, x):
            y = fn(ws, x).clone()
            y[0] = float("nan")
            return y
        return run

    monkeypatch.setattr(srv, "_schedule", poisoning)
    for _ in range(4):
        srv.submit(ServeRequest("vnet", _vol()))
    res = {r.id: r for r in srv.drain()}
    assert sorted(res) == [0, 1, 2, 3]
    assert all(isinstance(r.error, PoisonedOutputError)
               and r.code == "poisoned_output" for r in res.values())
    for i in (0, 1, 2):
        assert str(res[i].error) == (f"request {i}: non-finite output "
                                     f"quarantined")
    assert str(res[3].error) == "batch poisoned on every re-run"
    s = srv.stats()
    assert s["quarantined"] == 4 and s["reruns"] == 2
    assert s["completed"] == 0


def test_weights_from_numpy_refuses_wrong_shapes(jax_specs, specs):
    tree = jax.tree_util.tree_map(np.asarray, dict(jax_specs[1].weights))
    graph = specs[1].graph_for(None)
    name = graph.layers[0].name
    tree[name] = tree[name][..., :1]
    with pytest.raises(WeightShapeError):
        weights_from_numpy(tree, "cpu", network=graph)
    with pytest.raises(WeightShapeError):
        vnet_spec(weights={}, **VOL_KW)
