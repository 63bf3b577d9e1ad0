"""The port's DCNN server on the CPU, against the JAX package's server.

Served outputs (bucket padding, batch padding and crop included) match
what the JAX ``DcnnServer`` serves for the same requests at 1e-4 in f32,
with the JAX specs' weights carried across by ``weights_from_numpy``.  The
rest mirrors ``tests/test_dcnn_server.py``: typed validation, queue
shedding, typed deadline expiry, bucketing and schedule reuse, LRU
eviction, retry with backoff, NaN quarantine, and the degradation path
(fallback to the ``xla`` engine and recovery, compile and budget failures,
both engines failing, the scripted-mix acceptance).  Where a
``FaultScript`` drives both servers, the port's engines per batch, its
counters and its bucket ``stats()`` are held against the JAX server's on
the same script; as in the reference tests, two ``xla`` engines under the
primary and fallback names stand in where no kernel is needed.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import engine as jengine  # noqa: E402
from repro.runtime import dcnn_server as jserver  # noqa: E402
from repro.runtime import faults as jfaults  # noqa: E402
from repro.runtime import serving as jserving  # noqa: E402
from repro_torch import quant  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    WeightShapeError,
    weights_from_numpy,
)
from repro_torch.core.engine import (  # noqa: E402
    EngineConfig,
    UniformEngine,
    compile_network,
)
from repro_torch.runtime.dcnn_server import (  # noqa: E402
    DcnnServer,
    ServeRequest,
    dcgan_gen_spec,
    pad_to,
    vnet_spec,
)
from repro_torch.runtime.faults import (  # noqa: E402
    FaultEvent,
    FaultScript,
    has_poison,
)
from repro_torch.runtime.serving import (  # noqa: E402
    Backoff,
    DeadlineExceededError,
    DispatchFailedError,
    InvalidRequestError,
    PoisonedOutputError,
    QueueFullError,
    ServeError,
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
    """A schedule that fails on the primary and on the fallback completes
    the batch with a typed DispatchFailedError."""
    strict = dict(strict_vmem=True, max_tile_bytes=64, device="cpu")
    srv = _server(specs, engines={       # no plan fits 64 bytes on either
        "pallas": UniformEngine(EngineConfig(**strict)),
        "xla": UniformEngine(EngineConfig(method="xla", **strict))})
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

    def poisoning(*a):
        fn = real(*a)

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


# ---------------------------------------------------------------------------
# Degradation and recovery, held against the JAX server on the same script.
# ---------------------------------------------------------------------------

COUNTERS = ("completed", "retries", "quarantined", "reruns", "fallbacks",
            "recoveries", "probes_failed", "dispatch_failures")
BUCKET_STATE = ("engine", "degraded", "batches", "fallbacks", "recoveries",
                "probes_failed")


def _logic_engines():
    """Two cheap ``xla`` engines under the primary and fallback names."""
    return {m: UniformEngine(EngineConfig(method="xla", device="cpu"))
            for m in ("pallas", "xla")}


def _jax_logic_engines():
    return {m: jengine.UniformEngine(jengine.EngineConfig(method="xla"))
            for m in ("pallas", "xla")}


def _jax_events(events):
    """The same events for the JAX package's script."""
    return [jfaults.FaultEvent(**{f: getattr(e, f) for f in (
        "kind", "at_call", "channel", "match", "count", "factor", "rows",
        "fill", "signum")}) for e in events]


def _pair(jax_specs, specs, events=(), *, logic=True, **kw):
    """A JAX server and the port's, each with its own script of
    ``events``."""
    engines = ((_jax_logic_engines(), _logic_engines()) if logic
               else (None, None))
    jsrv = jserver.DcnnServer(
        list(jax_specs), engines=engines[0],
        faults=jfaults.FaultScript(_jax_events(events)),
        backoff=jserving.Backoff(sleep=lambda s: None), **kw)
    tsrv = _server(specs, engines=engines[1], faults=FaultScript(events),
                   backoff=Backoff(sleep=lambda s: None), **kw)
    return jsrv, tsrv


def _reason_kind(reason):
    return None if reason is None else reason.split("(", 1)[0]


def _assert_same_stats(jsrv, tsrv):
    js, ts = jsrv.stats(), tsrv.stats()
    assert {k: ts[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}
    assert ts["buckets"].keys() == js["buckets"].keys()
    for name, jb in js["buckets"].items():
        tb = ts["buckets"][name]
        assert set(tb) == set(jb)
        assert {k: tb[k] for k in BUCKET_STATE} == \
            {k: jb[k] for k in BUCKET_STATE}
        assert _reason_kind(tb["fallback_reason"]) == \
            _reason_kind(jb["fallback_reason"])
    assert tsrv.health()["degraded_buckets"] == \
        jsrv.health()["degraded_buckets"]


def test_persistent_failure_falls_back_then_recovers(jax_specs, specs):
    # 6 consecutive dispatch errors on the pallas tag: batch 1 exhausts
    # retries (3 calls) and degrades; the first probe eats the rest and
    # fails; the second probe succeeds and the bucket recovers.
    jsrv, tsrv = _pair(jax_specs, specs, [FaultEvent(
        "error", at_call=1, match="pallas:vnet", count=6)], probe_every=2)
    seen = {"jax": [], "port": []}
    for _ in range(8):
        x = _vol()
        for key, srv, req in (("jax", jsrv, jserver.ServeRequest),
                              ("port", tsrv, ServeRequest)):
            srv.submit(req("vnet", x))
            res = srv.drain()
            assert len(res) == 1 and res[0].ok
            seen[key].append((res[0].engine, srv.stats()["buckets"][
                "vnet/8x8x8/b1"]["degraded"]))
    assert seen["port"] == seen["jax"]
    engines = [e for e, _ in seen["port"]]
    assert engines[0] == "xla" and engines[-1] == "pallas"
    assert seen["port"][-1][1] is False
    _assert_same_stats(jsrv, tsrv)
    s = tsrv.stats()
    assert s["fallbacks"] == 1 and s["recoveries"] == 1
    assert s["probes_failed"] >= 1
    b = s["buckets"]["vnet/8x8x8/b1"]
    assert b["engine"] == "pallas" and b["fallback_reason"] is None
    assert tsrv.health()["fully_primary"]


def test_compile_failure_falls_back(jax_specs, specs):
    jsrv, tsrv = _pair(jax_specs, specs, [FaultEvent(
        "compile_error", at_call=1, match="pallas:vnet")])
    x = _vol()
    jsrv.submit(jserver.ServeRequest("vnet", x))
    tsrv.submit(ServeRequest("vnet", x))
    jres, tres = jsrv.drain(), tsrv.drain()
    assert tres[0].ok and tres[0].engine == jres[0].engine == "xla"
    b = tsrv.stats()["buckets"]["vnet/8x8x8/b1"]
    assert b["degraded"] and "InjectedCompileError" in b["fallback_reason"]
    assert b["fallback_reason"] == \
        jsrv.stats()["buckets"]["vnet/8x8x8/b1"]["fallback_reason"]
    assert tsrv.health()["degraded_buckets"] == ["vnet/8x8x8/b1"]
    _assert_same_stats(jsrv, tsrv)


def test_vmem_budget_overflow_falls_back(jax_specs, specs):
    # a real strict-budget hand-kernel primary with an impossible budget:
    # the typed VmemBudgetError at planning time degrades the bucket
    jsrv, tsrv = _pair(jax_specs, specs, logic=False, max_tile_bytes=64)
    x = _seed()
    jsrv.submit(jserver.ServeRequest("dcgan_gen", x))
    tsrv.submit(ServeRequest("dcgan_gen", x))
    jres, tres = jsrv.drain(), tsrv.drain()
    assert tres[0].ok and tres[0].engine == jres[0].engine == "xla"
    b = tsrv.stats()["buckets"]["dcgan_gen/4x4/b1"]
    assert b["degraded"] and "VmemBudgetError" in b["fallback_reason"]
    _assert_same_stats(jsrv, tsrv)
    np.testing.assert_allclose(tres[0].output, jres[0].output,
                               atol=1e-4, rtol=1e-4)


def test_all_engines_failing_is_typed(jax_specs, specs):
    jsrv, tsrv = _pair(jax_specs, specs,
                       [FaultEvent("error", at_call=1, count=0)])
    x = _seed()
    jsrv.submit(jserver.ServeRequest("dcgan_gen", x))
    tsrv.submit(ServeRequest("dcgan_gen", x))
    jres, tres = jsrv.drain(), tsrv.drain()
    assert not tres[0].ok and tres[0].code == jres[0].code == \
        "dispatch_failed"
    assert isinstance(tres[0].error, DispatchFailedError)
    assert tres[0].engine is None
    assert tsrv.stats()["dispatch_failures"] == 1 and tsrv.health()["ok"]
    _assert_same_stats(jsrv, tsrv)


def test_served_outputs_match_xla_engine(specs):
    """Requests served through the hand-kernel primary (bucket padding,
    batch padding, crop and all) match a direct run of the port's ``xla``
    engine on the same padded geometry to 1e-4."""
    srv = _server(specs, max_batch=2)
    reqs = [ServeRequest("dcgan_gen", _seed()),
            ServeRequest("vnet", _vol((8, 8, 8))),
            ServeRequest("vnet", _vol((6, 7, 5)))]
    for r in reqs:
        srv.submit(r)
    res = {r.id: r for r in srv.drain()}
    assert all(r.ok and r.engine == "pallas" for r in res.values())
    assert srv.stats()["fallbacks"] == 0
    xla = UniformEngine(EngineConfig(method="xla", device="cpu"))
    for i, req in enumerate(reqs):
        spec = srv.specs[req.model]
        bsp = spec.bucket_spatial(tuple(req.x.shape[:-1]))
        apply, _ = compile_network(spec.graph_for(bsp), xla)
        with torch.inference_mode():
            ref = apply(spec.weights, torch.from_numpy(
                pad_to(req.x, bsp))[None])[0].numpy()
        got = res[i].output
        ref = ref[tuple(slice(0, d) for d in got.shape)]
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


def test_scripted_mix_acceptance(jax_specs, specs):
    """Everything at once, on the port's real engines (the plain versions
    of the kernels as primary, the ``xla`` lowering as fallback) beside the
    JAX server on the same script: transient dispatch errors, a persistent
    error window (fallback and recovery), NaN poisons, slow dispatches and
    deadline pressure.  Every request gets one result, the failures are
    typed and the same as the reference's, every served output matches
    the reference's to 1e-4, and the counters and bucket stats agree."""
    jclk, tclk = FakeClock(), FakeClock()
    events = [
        # one transient dispatch error on the generator (retry wins)
        FaultEvent("error", at_call=1, match="pallas:dcgan_gen"),
        # persistent window on the vnet bucket: fallback, then recover
        FaultEvent("error", at_call=2, match="pallas:vnet", count=4),
        # a slow dispatch advancing the (fake) clock past deadlines
        FaultEvent("slow", at_call=2, match="dcgan_gen", factor=2.0),
        # a poisoned row mid-run on the generator bucket
        FaultEvent("nan", at_call=4, match="dcgan_gen", rows=(0,)),
    ]
    kw = dict(max_batch=2, probe_every=1)
    jsrv = jserver.DcnnServer(
        list(jax_specs), engines=_jax_logic_engines(), clock=jclk,
        faults=jfaults.FaultScript(_jax_events(events), sleep=jclk.advance),
        backoff=jserving.Backoff(sleep=lambda s: None), **kw)
    tsrv = _server(specs, faults=FaultScript(events, sleep=tclk.advance),
                   clock=tclk, backoff=Backoff(sleep=lambda s: None), **kw)
    feeds = []
    for k in range(4):
        feeds.append(("dcgan_gen", _seed(), None))
        feeds.append(("vnet", _vol((8, 8, 8) if k % 2 == 0 else (6, 7, 5)),
                      None))
    # deadline pressure: expires while the slow dispatch advances the clock
    feeds.append(("vnet", _vol(), 0.5))
    feeds += [("dcgan_gen", _seed(), None) for _ in range(3)]
    # then more traffic, so the degraded vnet bucket gets probed back
    later = [("vnet", _vol((8, 8, 8)), None) for _ in range(4)]
    results = {}
    for key, srv, req in (("jax", jsrv, jserver.ServeRequest),
                          ("port", tsrv, ServeRequest)):
        out = []
        for batch in (feeds, later):
            for model, x, dl in batch:
                srv.submit(req(model, x, deadline_s=dl))
            out += srv.drain()
        results[key] = {r.id: r for r in out}
    got, ref = results["port"], results["jax"]
    assert sorted(got) == sorted(ref) == list(range(len(feeds) + len(later)))
    assert {i: (r.code, r.engine) for i, r in got.items()} == \
        {i: (r.code, r.engine) for i, r in ref.items()}
    failed = [r for r in got.values() if not r.ok]
    assert all(isinstance(r.error, ServeError) for r in failed)
    assert {r.code for r in failed} == {"poisoned_output",
                                        "deadline_exceeded"}
    for i, r in got.items():
        if r.ok:
            assert not has_poison(r.output)
            np.testing.assert_allclose(r.output, ref[i].output,
                                       atol=1e-4, rtol=1e-4)
    _assert_same_stats(jsrv, tsrv)
    s = tsrv.stats()
    assert s["fallbacks"] >= 1 and s["recoveries"] >= 1
    assert s["retries"] >= 1 and s["quarantined"] >= 1
    assert s["expired"] == jsrv.stats()["expired"] >= 1
    assert tsrv.health()["ok"]


def test_from_seed_is_deterministic():
    a = FaultScript.from_seed(7, calls=16, p_error=0.3, p_nan=0.2)
    b = FaultScript.from_seed(7, calls=16, p_error=0.3, p_nan=0.2)
    j = jfaults.FaultScript.from_seed(7, calls=16, p_error=0.3, p_nan=0.2)
    assert [(e.kind, e.at_call) for e in a.events] == \
        [(e.kind, e.at_call) for e in b.events] == \
        [(e.kind, e.at_call) for e in j.events]
    assert a.events, "seed 7 at these rates must script something"


def test_default_fallback_ignores_the_primarys_precision(specs):
    """A reference behaviour, pinned: the self-built fallback has the
    default precision whatever the primary's, so a bucket degraded from
    an int8-activation primary serves without activation quantization
    (int8 weights dequantized up front)."""
    prec = quant.Precision(weight_quant="int8", act_quant="int8")
    qspec = vnet_spec(weights=quant.quantize_weights(
        dict(specs[1].weights), prec), **VOL_KW)
    srv = DcnnServer(
        [qspec], engine=UniformEngine(EngineConfig(precision=prec,
                                                   device="cpu")),
        faults=FaultScript([FaultEvent("compile_error",
                                       match="pallas:vnet")]))
    fb = srv.engines["xla"].config
    assert srv.engine.config.precision == prec
    assert fb.precision == quant.Precision() and fb.device.type == "cpu"
    jfb = jserver.DcnnServer([jserver.vnet_spec(**VOL_KW)]).engines["xla"]
    assert fb.precision.describe() == jfb.config.precision.describe()
    x = _vol()
    srv.submit(ServeRequest("vnet", x))
    res = srv.drain()[0]
    assert res.ok and res.engine == "xla"
    graph = qspec.graph_for(None)
    outs = {}
    for name, p in (("default", None), ("policy", prec)):
        apply, _ = compile_network(graph, UniformEngine(EngineConfig(
            method="xla", precision=p, device="cpu")))
        with torch.inference_mode():
            outs[name] = apply(qspec.weights,
                               torch.from_numpy(x)[None])[0].numpy()
    np.testing.assert_array_equal(res.output, outs["default"])
    assert np.abs(res.output - outs["policy"]).max() > 0
