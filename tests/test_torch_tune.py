"""The port's autotuner (``repro_torch.tune``, ``launch/tune.py``) on the
Hopper planner, against the JAX package's ``repro.tune`` contracts.

* ``network_geometries`` gives the reference's geometries for the DCGAN
  chain and the V-Net graph (operand widths apart: the port's are real
  element sizes);
* the design space (each route's tiles x both split policies) fits the
  budget by construction and holds the heuristic's plan; strict engines
  accept every candidate;
* model-only tuning is deterministic, the model's winner never
  modeled-worse than the heuristic, the measured one never slower (a
  stubbed timer); ``tune_network`` dedups and skips cached geometries;
* the cache round-trips losslessly, refuses over-budget entries, loads a
  file of another schema (the reference's v2 included) empty or raises
  under ``strict``; the engine's tuned and heuristic counters, the
  search-free reload, and ``measure_plan`` pinning its candidate;
* the split policy ``"off"`` makes the schedule row and ``launch_split``
  agree on one slice, and the ops hand the wrappers the plan's tile and
  split.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import tune as jtune  # noqa: E402
from repro.core import networks as jnet  # noqa: E402
from repro.core.engine import UniformEngine as JaxEngine  # noqa: E402
from repro.core.engine import compile_network as j_compile  # noqa: E402
from repro_torch import obs, tune  # noqa: E402
from repro_torch.convert import weights_from_numpy  # noqa: E402
from repro_torch.core import networks as tnet  # noqa: E402
from repro_torch.core import tiling  # noqa: E402
from repro_torch.core.engine import (  # noqa: E402
    EngineConfig,
    UniformEngine,
    compile_network,
)
from repro_torch.kernels.conv import kernel as conv_kernel  # noqa: E402
from repro_torch.kernels.deconv import kernel as deconv_kernel  # noqa: E402
from repro_torch.launch import tune as launch_tune  # noqa: E402
from repro_torch.quant import Precision  # noqa: E402
from repro_torch.tune import search as tsearch  # noqa: E402
from repro_torch.tune.cache import TunedEntry  # noqa: E402

CPU = dict(device="cpu")
GEOM = tune.LayerGeometry(mode="deconv", in_spatial=(4, 1, 4),
                          kernel=(3, 1, 3), stride=(2, 1, 2), cin=8, cout=4)
GEOM3 = tune.LayerGeometry(mode="deconv", in_spatial=(4, 4, 4),
                           kernel=(3, 3, 3), stride=(2, 2, 2), cin=8, cout=8)
# one geometry per route: f32 x f32, f32 x int8, int8 x int8, bf16 x bf16
WIDTHS = {"fma": (4, 4), "tf32": (4, 1), "s8": (1, 1), "bf16": (2, 2)}
# DCGAN's first deconv at batch 4: the heuristic splits its reduction
SPLIT_GEOM = tune.LayerGeometry(mode="deconv", in_spatial=(4, 1, 4),
                                kernel=(3, 1, 3), stride=(2, 1, 2),
                                cin=1024, cout=512)


def _chain(net):
    return net.deconv_stack("t", 2, 4, [8, 4, 3])


def _widths(geom, route):
    a, w = WIDTHS[route]
    return dataclasses.replace(geom, in_dtype_bytes=a, w_dtype_bytes=w)


def _plan(eng, g):
    return eng.plan(g.mode, g.in_spatial, g.kernel, g.stride, g.cin,
                    g.cout, groups=g.groups, dilation=g.dilation,
                    in_dtype_bytes=g.in_dtype_bytes,
                    w_dtype_bytes=g.w_dtype_bytes)


# ---------------------------------------------------------------------------
# Geometries: the reference's, operand widths apart
# ---------------------------------------------------------------------------

FIELDS = ("mode", "in_spatial", "kernel", "stride", "cin", "cout", "groups",
          "dilation")


@pytest.mark.parametrize("make", ["dcgan", "vnet_graph", "chain"])
def test_network_geometries_match_the_reference(make):
    build = {"dcgan": lambda n: n.dcgan(),
             "vnet_graph": lambda n: n.vnet_graph(), "chain": _chain}[make]
    got = tune.network_geometries(build(tnet))
    want = jtune.network_geometries(build(jnet))
    assert [tuple(getattr(g, f) for f in FIELDS) for g in got] == \
        [tuple(getattr(g, f) for f in FIELDS) for g in want]
    assert {(g.in_dtype_bytes, g.w_dtype_bytes) for g in got} == {(4, 4)}


@pytest.mark.parametrize("prec,dtype,want", [
    (Precision(weight_quant="int8"), torch.float32, (4, 1)),
    (Precision(weight_quant="int8", act_quant="int8"), torch.float32,
     (1, 1)),
    (Precision(), torch.bfloat16, (2, 2)),
    (Precision(weight_quant="int8"), torch.bfloat16, (2, 1))])
def test_network_geometries_take_the_engines_operand_widths(prec, dtype,
                                                            want):
    graph = tnet.vnet_graph(in_spatial=(8, 8, 8), chans=(2, 4), cin=1)
    geoms = tune.network_geometries(graph, precision=prec, dtype=dtype)
    assert {(g.in_dtype_bytes, g.w_dtype_bytes) for g in geoms} == {want}
    eng = UniformEngine(EngineConfig(precision=prec, **CPU))
    compile_network(graph, eng, dtype=dtype)
    assert {g.key_tuple for g in geoms} == set(eng.plan_cache)


# ---------------------------------------------------------------------------
# The design space: within the budget, the heuristic one of its points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", sorted(WIDTHS))
def test_every_candidate_fits_the_budget(route):
    budget = 72 * 1024
    cands = tune.candidate_plans(_widths(GEOM3, route), smem_budget=budget)
    assert cands
    for p in cands:
        assert p.step_smem_bytes <= budget and not p.overflows
        assert p.split in tiling.SPLIT_POLICIES
    assert len(set(cands)) == len(cands)


@pytest.mark.parametrize("route", sorted(WIDTHS))
def test_the_design_space_is_the_routes_tiles_times_the_policies(route):
    g = _widths(GEOM3, route)
    assert g.route == route        # bf16 x bf16 plans on the bf16 route
    cands = tune.candidate_plans(g)
    table = tiling.ROUTE_TILES[g.route]
    assert {(p.block_co, p.split) for p in cands} == {
        (b, s) for b in table for s in tiling.SPLIT_POLICIES}
    heur = tiling.plan_uniform_tiles(
        g.cin, g.cout, mode=g.mode, in_dtype_bytes=g.in_dtype_bytes,
        w_dtype_bytes=g.w_dtype_bytes)
    assert heur in cands


@pytest.mark.parametrize("route", sorted(WIDTHS))
def test_strict_engine_accepts_every_candidate(route):
    budget = 72 * 1024
    g = _widths(GEOM3, route)
    for p in tune.candidate_plans(g, smem_budget=budget):
        cache = tune.TunedPlanCache()
        cache.put(g.key_tuple, p)
        eng = UniformEngine(EngineConfig(max_tile_bytes=budget,
                                         strict_vmem=True, tuned_plans=cache,
                                         **CPU))
        assert _plan(eng, g) == p
        assert eng.plan_sources == {"tuned": 1, "heuristic": 0}


def test_overflowing_geometry_falls_back_to_the_heuristic_plan():
    cands = tune.candidate_plans(GEOM3, smem_budget=1)
    assert len(cands) == 1 and cands[0].overflows
    res = tune.tune_layer(GEOM3, smem_budget=1, measure_topk=2, **CPU)
    assert res.plan == res.heuristic and res.measured == {}


# ---------------------------------------------------------------------------
# The cost model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", sorted(WIDTHS))
def test_cost_terms(route):
    g = _widths(SPLIT_GEOM, route)
    for p in tune.candidate_plans(g):
        t = tiling.plan_cost_terms(
            p, g.in_spatial, g.kernel, g.stride, g.cin, g.cout, mode=g.mode,
            in_dtype_bytes=g.in_dtype_bytes, w_dtype_bytes=g.w_dtype_bytes,
            batch=4)
        rows, phases, depth = tiling.launch_shape(
            g.mode, g.in_spatial, g.kernel, g.stride, g.cin, batch=4)
        splits, _ = tiling.launch_split(p, rows, depth, g.cout, 1, phases)
        assert t["route"] == g.route and t["splits"] == splits
        assert t["launches"] == (2 if splits > 1 else 1)
        assert t["blocks"] == tiling.grid_blocks(p, rows, g.cout, 1, phases,
                                                 splits)
        assert t["waves"] >= 1 and t["bytes"] > 0
        # padded work covers the valid work
        assert t["flops"] >= 2 * rows * phases * depth * g.cout
        if p.split == "off":
            assert t["splits"] == 1
        assert tiling.modeled_cost(t) > 0


def test_launch_shape_matches_the_schedule_rows():
    eng = UniformEngine(**CPU)
    graph = tnet.vnet_graph(in_spatial=(8, 8, 8), chans=(2, 4), cin=1)
    _, report = compile_network(graph, eng, batch=3)
    geoms = {g.key_tuple: g for g in tune.network_geometries(graph)}
    for row in report.layers:
        if row.plan is None:
            continue
        key = next(k for k, v in eng.plan_cache.items() if v is row.plan
                   and k[0] == row.op and k[4:6] == (row.cin, row.cout))
        g = geoms[key]
        t = tiling.plan_cost_terms(row.plan, g.in_spatial, g.kernel,
                                   g.stride, g.cin, g.cout, mode=g.mode,
                                   batch=3)
        assert (t["blocks"], t["splits"]) == (row.blocks, row.splits)


def test_rank_orders_by_the_model():
    model = tune.LatencyModel()
    cands = tune.candidate_plans(SPLIT_GEOM)
    ranked = model.rank(cands, SPLIT_GEOM, batch=4)
    costs = [model.layer_seconds(p, SPLIT_GEOM, batch=4) for p in ranked]
    assert costs == sorted(costs) and set(ranked) == set(cands)


def test_calibrate_takes_the_probes_or_their_overrides(monkeypatch):
    monkeypatch.setenv("REPRO_PEAK_GFLOPS", "123.0")
    monkeypatch.setenv("REPRO_MEM_GBPS", "45.0")
    model = tune.LatencyModel.calibrate()
    assert model.peak_flops == pytest.approx(123.0e9)
    assert model.mem_bps == pytest.approx(45.0e9)
    nominal = tune.LatencyModel()
    assert (model.tf32_flops, model.int8_ops, model.bf16_flops) == (
        nominal.tf32_flops, nominal.int8_ops, nominal.bf16_flops)
    assert model.route_flops["bf16"] == tiling.NOMINAL_ROUTE_FLOPS["bf16"]
    assert nominal.peak_flops == 67e12 and nominal.mem_bps == 3.35e12
    monkeypatch.delenv("REPRO_PEAK_GFLOPS")
    monkeypatch.delenv("REPRO_MEM_GBPS")
    host = tune.LatencyModel.calibrate(device="cpu")
    assert host.peak_flops > 0 and host.mem_bps > 0


# ---------------------------------------------------------------------------
# The tuner
# ---------------------------------------------------------------------------

def test_model_only_tuning_is_deterministic():
    a = tune.tune_layer(SPLIT_GEOM, trials=4, measure_topk=0, seed=7,
                        batch=4)
    b = tune.tune_layer(SPLIT_GEOM, trials=4, measure_topk=0, seed=7,
                        batch=4)
    assert a.plan == b.plan and a.scored == b.scored
    assert a.entry.to_json() == b.entry.to_json()


@pytest.mark.parametrize("trials", [2, 4, 64])
def test_model_winner_never_modeled_worse_than_the_heuristic(trials):
    model = tune.LatencyModel()
    for geom in (GEOM3, SPLIT_GEOM, _widths(SPLIT_GEOM, "tf32")):
        for seed in range(3):
            res = tune.tune_layer(geom, trials=trials, measure_topk=0,
                                  seed=seed, model=model, batch=4)
            assert (model.layer_seconds(res.plan, geom, batch=4)
                    <= model.layer_seconds(res.heuristic, geom, batch=4)
                    + 1e-15)
            assert res.entry.winner_source == "model"


def _stub_timer(monkeypatch, seconds):
    calls = []

    def fake(plan, geom, **kw):
        calls.append((plan, kw))
        return seconds(plan)

    monkeypatch.setattr(tsearch, "measure_plan", fake)
    return calls


def test_measured_winner_never_slower_than_the_heuristic(monkeypatch):
    heur = tiling.plan_uniform_tiles(1024, 512)
    # every other plan slower than the heuristic: it wins from the pool
    calls = _stub_timer(monkeypatch,
                        lambda p: 1e-3 if p == heur else 2e-3 + p.block_co)
    res = tune.tune_layer(SPLIT_GEOM, measure_topk=2, batch=4, **CPU)
    assert res.plan == heur and res.entry.measured_s == 1e-3
    assert res.entry.heuristic_measured_s == 1e-3
    assert res.entry.winner_source in ("measured", "heuristic")
    assert len(calls) == len(res.measured) in (2, 3)
    assert all(kw["batch"] == 4 and kw["device"] == "cpu"
               for _, kw in calls)
    # a faster candidate wins, never slower than the heuristic
    _stub_timer(monkeypatch, lambda p: 1e-3 / p.block_co)
    res = tune.tune_layer(SPLIT_GEOM, measure_topk=8, batch=4, **CPU)
    assert res.entry.measured_s <= res.entry.heuristic_measured_s
    assert res.plan.block_co == 128 and res.entry.winner_source == "measured"
    assert res.entry.measured_s == min(res.measured.values())


def test_tune_network_dedups_geometries_and_skips_cached():
    chain = _chain(tnet) + [dataclasses.replace(_chain(tnet)[1],
                                                name="t.again")]
    cache, results = tune.tune_network(chain[:2], trials=4, measure_topk=0)
    assert len(cache) == len(results) == len(
        tune.network_geometries(chain)) == 2
    cache2, results2 = tune.tune_network(chain, trials=4, measure_topk=0,
                                         cache=cache)
    assert cache2 is cache and results2 == []


# ---------------------------------------------------------------------------
# The cache
# ---------------------------------------------------------------------------

def _filled():
    cache, _ = tune.tune_network(_chain(tnet), trials=4, measure_topk=0)
    cache.meta["note"] = "t"
    return cache


def test_round_trip(tmp_path):
    cache = _filled()
    cache.put(SPLIT_GEOM.key_tuple, dataclasses.replace(
        tiling.plan_uniform_tiles(1024, 512, split="off")),
        measured_s=2e-6, winner_source="measured", batch=4)
    path = cache.save(tmp_path / "tuned.json")
    loaded = tune.TunedPlanCache.load(path, strict=True)
    assert len(loaded) == len(cache) == 3
    assert loaded.meta["note"] == "t"
    for key, entry in cache.entries.items():
        assert loaded.entries[key] == entry
        assert loaded.entries[key].to_json() == entry.to_json()
    payload = json.loads(path.read_text())
    assert (payload["kind"], payload["schema_version"]) == (
        tune.CACHE_KIND, tune.SCHEMA_VERSION)


def test_entry_json_is_lossless():
    plan = tiling.plan_uniform_tiles(64, 128, in_dtype_bytes=4,
                                     w_dtype_bytes=1, split="off")
    entry = TunedEntry(plan=plan, modeled_s=1e-6, measured_s=2e-6,
                       heuristic_measured_s=3e-6, trials=4, candidates=8,
                       seed=1, batch=4, winner_source="measured")
    assert TunedEntry.from_json(json.loads(json.dumps(entry.to_json()))) \
        == entry


def test_plan_key_is_the_engines_key():
    eng = UniformEngine(**CPU)
    _plan(eng, GEOM)
    (key,) = eng.plan_cache
    assert key == GEOM.key_tuple
    assert tune.plan_key(GEOM.mode, GEOM.in_spatial, GEOM.kernel,
                         GEOM.stride, GEOM.cin, GEOM.cout) == \
        tune.key_from_tuple(key) == GEOM.describe()


def test_lookup_refuses_over_budget_plans():
    cache = tune.TunedPlanCache()
    plan = tiling.plan_uniform_tiles(GEOM.cin, GEOM.cout)
    cache.put(GEOM.key_tuple, plan)
    assert cache.lookup(GEOM.key_tuple) == plan
    assert cache.lookup(GEOM.key_tuple,
                        smem_budget=plan.step_smem_bytes - 1) is None
    assert cache.lookups == 2 and cache.hits == 1


def test_over_budget_tuned_entry_falls_back_to_the_heuristic():
    cache = tune.TunedPlanCache()
    big = tiling.plan_uniform_tiles(GEOM.cin, GEOM.cout, block_co=128)
    cache.put(GEOM.key_tuple, big)
    eng = UniformEngine(EngineConfig(max_tile_bytes=big.step_smem_bytes - 1,
                                     tuned_plans=cache, **CPU))
    plan = _plan(eng, GEOM)
    assert plan != big and not plan.overflows
    assert eng.plan_sources == {"tuned": 0, "heuristic": 1}


def test_schema_mismatch_loads_empty(tmp_path):
    payload = _filled().to_json()
    payload["schema_version"] = tune.SCHEMA_VERSION + 1
    path = tmp_path / "stale.json"
    path.write_text(json.dumps(payload))
    loaded = tune.TunedPlanCache.load(path)
    assert len(loaded) == 0
    assert loaded.meta["invalidated_version"] == tune.SCHEMA_VERSION + 1


def test_schema_mismatch_raises_under_strict(tmp_path):
    path = tmp_path / "stale.json"
    path.write_text(json.dumps({"schema_version": 0, "entries": {}}))
    with pytest.raises(tune.TunedPlanSchemaError):
        tune.TunedPlanCache.load(path, strict=True)


def test_the_references_cache_file_is_refused(tmp_path):
    jcache, _ = jtune.tune_network(_chain(jnet), trials=4, measure_topk=0)
    path = jcache.save(tmp_path / "jax.json")
    assert json.loads(path.read_text())["schema_version"] == 2
    loaded = tune.TunedPlanCache.load(path)
    assert len(loaded) == 0
    assert loaded.meta["invalidated_kind"] == "tuned_plan_cache"
    with pytest.raises(tune.TunedPlanSchemaError, match="tuned_plan_cache"):
        tune.TunedPlanCache.load(path, strict=True)


# ---------------------------------------------------------------------------
# The engine: tuned hits vs heuristic, the search-free reload
# ---------------------------------------------------------------------------

def test_plan_consults_the_tuned_cache_before_the_heuristic():
    cache, _ = tune.tune_network(_chain(tnet), trials=4, measure_topk=0)
    tel = obs.Telemetry.create()
    eng = UniformEngine(EngineConfig(tuned_plans=cache, telemetry=tel,
                                     **CPU))
    geoms = tune.network_geometries(_chain(tnet))
    for g in geoms:
        assert _plan(eng, g) == cache.get(g.describe()).plan
    assert eng.plan_sources == {"tuned": len(geoms), "heuristic": 0}
    assert tel.registry.get(
        "engine_plan_tuned_hits_total").value == len(geoms)
    assert tel.registry.get("engine_plan_heuristic_total") is None


def test_counters_tell_tuned_hits_from_the_heuristic():
    tel = obs.Telemetry.create()
    eng = UniformEngine(EngineConfig(tuned_plans=tune.TunedPlanCache(),
                                     telemetry=tel, **CPU))
    _plan(eng, GEOM)
    assert eng.plan_sources == {"tuned": 0, "heuristic": 1}
    assert tel.registry.get("engine_plan_heuristic_total").value == 1
    assert tel.registry.get("engine_plan_tuned_hits_total") is None
    _plan(eng, GEOM)                          # memo hit: no source moves
    assert eng.plan_sources == {"tuned": 0, "heuristic": 1}
    assert tel.registry.get("engine_plan_cache_hits_total").value == 1


def test_backward_plans_take_the_heuristic():
    cache = tune.TunedPlanCache()
    g = dataclasses.replace(GEOM3, cin=32, cout=64)
    cache.put(g.key_tuple, tiling.plan_uniform_tiles(32, 64, block_co=16))
    eng = UniformEngine(EngineConfig(tuned_plans=cache, **CPU))
    plan = eng.plan(g.mode, g.in_spatial, g.kernel, g.stride, g.cin, g.cout,
                    backward=True, rows=512)
    assert isinstance(plan, tiling.BackwardPlan)
    assert eng.plan_sources == {"tuned": 0, "heuristic": 1}
    assert cache.lookups == 0
    assert _plan(eng, g).block_co == 16
    assert eng.plan_sources == {"tuned": 1, "heuristic": 1}


def test_reload_is_search_free_and_matches_the_reference(tmp_path):
    chain = _chain(tnet)
    cache, _ = tune.tune_network(chain, trials=8, measure_topk=0)
    path = cache.save(tmp_path / "tuned.json")
    loaded = tune.TunedPlanCache.load(path, strict=True)
    tel = obs.Telemetry.create()
    eng = UniformEngine(EngineConfig(tuned_plans=loaded, telemetry=tel,
                                     **CPU))
    fn, _ = compile_network(chain, eng)
    assert eng.plan_sources["heuristic"] == 0
    assert eng.plan_sources["tuned"] == len(eng.plan_cache) > 0
    assert tel.registry.get("engine_plan_heuristic_total") is None
    assert loaded.hits == loaded.lookups == len(eng.plan_cache)
    assert launch_tune.verify_zero_search(loaded, {"chain": chain},
                                          **CPU)["chain"]["heuristic"] == 0

    rng = np.random.default_rng(0)
    ws = [(0.3 * rng.normal(size=l.weight_shape)).astype(np.float32)
          for l in chain]
    x = rng.normal(size=(2, 4, 4, 8)).astype(np.float32)
    got = fn(weights_from_numpy(ws, "cpu", network=chain),
             torch.from_numpy(x))
    want, _ = j_compile(_chain(jnet), JaxEngine(method="xla"))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(want([jnp.asarray(w) for w in ws],
                                     jnp.asarray(x))), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("route", sorted(WIDTHS))
def test_measure_plan_pins_its_candidate(route, monkeypatch):
    g = _widths(dataclasses.replace(GEOM, cout=24), route)
    seen = []
    real = deconv_kernel.deconv_fwd

    def spy(x, w, **kw):
        seen.append((x.element_size(), w.element_size(), kw["block_co"],
                     kw["split"]))
        return real(x, w, **kw)

    monkeypatch.setattr(deconv_kernel, "deconv_fwd", spy)
    for p in tune.candidate_plans(g):
        seen.clear()
        s = tune.measure_plan(p, g, repeats=1, batch=2, **CPU)
        assert s > 0
        assert set(seen) == {(g.in_dtype_bytes, g.w_dtype_bytes,
                              p.block_co, p.split)}


def test_operand_policy_refuses_widths_no_kernel_takes():
    with pytest.raises(ValueError, match="widths"):
        tune.operand_policy(dataclasses.replace(GEOM, in_dtype_bytes=1,
                                                w_dtype_bytes=4))


# ---------------------------------------------------------------------------
# The split policy in the schedule and at the launch
# ---------------------------------------------------------------------------

def _split_layer(net):
    return net.UniformLayer(name="g.deconv1", in_spatial=(4, 4), cin=1024,
                            cout=512, kernel=(3, 3), stride=(2, 2),
                            padding=((0, 1), (0, 1)))


@pytest.mark.parametrize("split", tiling.SPLIT_POLICIES)
def test_split_policy_sets_the_schedule_row_and_the_launch(split,
                                                           monkeypatch):
    layer = _split_layer(tnet)
    (g,) = tune.network_geometries([layer])
    cache = tune.TunedPlanCache()
    plan = tiling.plan_uniform_tiles(1024, 512, split=split)
    cache.put(g.key_tuple, plan)
    eng = UniformEngine(EngineConfig(tuned_plans=cache, **CPU))
    _, report = compile_network([layer], eng, batch=4)
    (row,) = report.layers
    rows, phases, depth = tiling.launch_shape(
        g.mode, g.in_spatial, g.kernel, g.stride, g.cin, batch=4)
    want = tiling.launch_split(plan, rows, depth, 512, 1, phases)
    assert row.splits == want[0]
    assert (row.splits == 1) == (split == "off")
    if split == "off":
        assert want == (1, -(-depth // tiling.SPLIT_UNIT)
                        * tiling.SPLIT_UNIT)
        assert row.describe().count("_unsplit") == 1
    # the op hands the wrapper the plan's tile and policy, from which it
    # plans the launch's split as the row does
    seen = []
    real = deconv_kernel.deconv_fwd
    monkeypatch.setattr(deconv_kernel, "deconv_fwd", lambda x, w, **kw: (
        seen.append((kw["block_co"], kw["split"])), real(x, w, **kw))[1])
    eng.deconv(torch.zeros(4, 4, 4, 1024), torch.zeros(3, 3, 1024, 512), 2,
               ((0, 1), (0, 1)))
    assert seen == [(plan.block_co, split)]
    launched = tiling.plan_uniform_tiles(1024, 512, block_co=plan.block_co,
                                         split=split)
    assert tiling.launch_split(launched, rows, depth, 512, 1, phases) == want


def test_conv_ops_hand_the_wrapper_the_tuned_split(monkeypatch):
    layer = tnet.UniformLayer(name="c", in_spatial=(8, 8, 4), cin=128,
                              cout=256, kernel=(3, 3, 3), stride=(2, 2, 2),
                              padding=1, op="conv")
    (g,) = tune.network_geometries([layer])
    cache = tune.TunedPlanCache()
    cache.put(g.key_tuple, tiling.plan_uniform_tiles(128, 256, mode="conv",
                                                     block_co=64,
                                                     split="off"))
    eng = UniformEngine(EngineConfig(tuned_plans=cache, **CPU))
    seen = []
    real = conv_kernel.conv_fwd
    monkeypatch.setattr(conv_kernel, "conv_fwd", lambda x, w, **kw: (
        seen.append((kw["block_co"], kw["split"])), real(x, w, **kw))[1])
    eng(layer, torch.zeros(1, 8, 8, 4, 128), torch.zeros(3, 3, 3, 128, 256))
    assert seen == [(64, "off")] and eng.plan_sources["tuned"] == 1


def test_split_policy_is_checked():
    with pytest.raises(ValueError, match="split"):
        tiling.plan_uniform_tiles(8, 8, split="sometimes")


# ---------------------------------------------------------------------------
# The sweep (launch/tune.py)
# ---------------------------------------------------------------------------

def test_sweep_model_only_reload_is_search_free(tmp_path, capsys):
    out = tmp_path / "tuned.json"
    assert launch_tune.main(["--device", "cpu", "--model-only",
                             "--networks", "dcgan_gen,vnet,dcgan",
                             "--batch", "4", "--out", str(out)]) == 0
    printed = capsys.readouterr().out
    summary = json.loads(printed[printed.index("{\n"):])
    loaded = tune.TunedPlanCache.load(out, strict=True)
    assert summary["entries"] == len(loaded) > 0
    nets = launch_tune.bench_networks()
    counts = launch_tune.verify_zero_search(
        loaded, {n: nets[n] for n in ("dcgan_gen", "vnet", "dcgan")}, **CPU)
    assert all(c["heuristic"] == 0 and c["tuned_hits"] == c["plans"] > 0
               for c in counts.values())
    assert counts == summary["zero_search_reload"]
    assert loaded.meta["batch"] == 4 and loaded.meta["measure_topk"] == 0
    # a resumed sweep searches nothing new
    assert launch_tune.main(["--device", "cpu", "--model-only", "--resume",
                             "--networks", "dcgan_gen", "--out",
                             str(out)]) == 0
    printed = capsys.readouterr().out
    assert json.loads(printed[printed.index("{\n"):])["tuned"] == {
        "dcgan_gen": []}


def test_sweep_int8_weights_and_model_overrides(tmp_path, capsys):
    out = tmp_path / "w8.json"
    assert launch_tune.main(["--device", "cpu", "--model-only",
                             "--networks", "vnet", "--weight-quant", "int8",
                             "--set", "mem_bps=1e12", "--out",
                             str(out)]) == 0
    loaded = tune.TunedPlanCache.load(out, strict=True)
    assert loaded.meta["model"]["mem_bps"] == 1e12
    assert all(k.endswith(":a4:w1") for k in loaded)
    capsys.readouterr()


def test_sweep_refuses_unknown_networks():
    with pytest.raises(SystemExit):
        launch_tune.main(["--device", "cpu", "--model-only", "--networks",
                          "resnet"])


@pytest.mark.parametrize("text,want", [("3", 3), ("2.5e9", 2.5e9),
                                       ("true", True), ("False", False),
                                       ("fma", "fma")])
def test_parse_value(text, want):
    got = launch_tune.parse_value(text)
    assert got == want and type(got) is type(want)


@pytest.mark.parametrize("geom,batch,want", [
    # V-Net's merge4 at batch 4 fills the card unsplit: each tile once
    (tune.LayerGeometry(mode="conv", in_spatial=(130, 130, 66),
                        kernel=(3, 3, 3), stride=(1, 1, 1), cin=32,
                        cout=16), 4, 4),
    # DCGAN's first deconv splits on every tile: each tile twice
    (SPLIT_GEOM, 4, 8)])
def test_tuning_measures_each_distinct_launch_once(geom, batch, want):
    cands = tune.candidate_plans(geom)
    distinct = tune.distinct_launches(cands, geom, batch=batch)
    assert len(cands) == 8 and len(distinct) == want
    heur = tiling.plan_uniform_tiles(geom.cin, geom.cout, mode=geom.mode)
    assert heur in distinct
    res = tune.tune_layer(geom, measure_topk=0, batch=batch)
    assert res.candidates == want
