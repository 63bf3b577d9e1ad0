"""Search-based autotuning of tile plans: model-ranked, measurement-picked
(the JAX package's ``tune/search.py`` on the Hopper planner).

  1. **Enumerate** a geometry's design space (``tune.model.
     candidate_plans``: the route's tiles x the split policies, each
     within the shared-memory budget), one plan per distinct launch at
     the batch (``distinct_launches``).
  2. **Search** it under the ``LatencyModel``.  Small spaces (every one
     the Hopper planner has today) are scored exhaustively; larger ones
     get a seeded random sweep plus a simulated-annealing walk over the
     (tile, split) lattice — deterministic for a fixed seed.
  3. **Measure** the model's top-k candidates, plus the heuristic's plan
     always, on the card: each candidate is pinned into a fresh engine
     through a single-entry ``TunedPlanCache`` and timed with
     ``obs.measure_network`` at the geometry's own operand widths and the
     given batch.  The fastest is cached; with ``measure_topk=0`` tuning
     is model-only and exactly reproducible.

``tune_layer`` handles one geometry; ``tune_network`` walks a chain or a
``UniformGraph``, tunes each unique geometry once, and returns the filled
cache, ready to persist and to hand to ``EngineConfig(tuned_plans=...)``.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Sequence

import torch

from repro_torch.core import tiling as _tiling
from repro_torch.tune.cache import TunedEntry, TunedPlanCache, key_from_tuple
from repro_torch.tune.model import (
    LatencyModel,
    LayerGeometry,
    candidate_plans,
    distinct_launches,
    plan_order,
)


@dataclasses.dataclass(frozen=True)
class TuneResult:
    """One geometry's tuning outcome (the cache entry, plus provenance
    the sweep reports)."""
    geometry: LayerGeometry
    key: str
    plan: _tiling.DeconvTilePlan          # the winner
    heuristic: _tiling.DeconvTilePlan     # what the heuristic would run
    entry: TunedEntry
    candidates: int                       # design points enumerated
    scored: int                           # points the search scored
    measured: dict                        # plan.describe() -> seconds

    @property
    def improved(self) -> bool:
        return self.plan != self.heuristic

    def describe(self) -> str:
        meas = (f" measured={self.entry.measured_s * 1e6:.1f}us"
                f" (heuristic {self.entry.heuristic_measured_s * 1e6:.1f}us)"
                if self.entry.measured_s else "")
        return (f"{self.key:<60s} {self.plan.describe():<40s} "
                f"[{self.entry.winner_source}] cands={self.candidates} "
                f"scored={self.scored}{meas}")

    def to_json(self) -> dict:
        return {
            "key": self.key,
            "plan": self.plan.describe(),
            "heuristic": self.heuristic.describe(),
            "improved": self.improved,
            "winner_source": self.entry.winner_source,
            "candidates": self.candidates,
            "scored": self.scored,
            "modeled_s": self.entry.modeled_s,
            "measured_us": round(self.entry.measured_s * 1e6, 2),
            "heuristic_measured_us": round(
                self.entry.heuristic_measured_s * 1e6, 2),
        }


# ---------------------------------------------------------------------------
# The search: exhaustive when small, seeded sweep + annealing when not.
# ---------------------------------------------------------------------------

def _anneal(cands: list, scores: dict, model: LatencyModel,
            geom: LayerGeometry, rng: random.Random, start,
            steps: int, batch: int = 1) -> None:
    """Simulated-annealing refinement over the (tile, split) lattice.

    A move steps ONE coordinate to its adjacent value; points outside the
    space (over the budget) are skipped.  Scores memoize into ``scores``:
    the caller ranks whatever the walk touched, so annealing only ever
    adds to the random sweep.
    """
    by_coord = {plan_order(p): p for p in cands}
    axes = [sorted({c[i] for c in by_coord}) for i in range(2)]

    def score(p):
        if p not in scores:
            scores[p] = model.layer_seconds(p, geom, batch=batch)
        return scores[p]

    cur = start
    t0 = max(score(start), 1e-12)
    for i in range(steps):
        coord = list(plan_order(cur))
        axis = rng.randrange(2)
        vals = axes[axis]
        idx = vals.index(coord[axis]) + rng.choice((-1, 1))
        if not 0 <= idx < len(vals):
            continue
        coord[axis] = vals[idx]
        nxt = by_coord.get(tuple(coord))
        if nxt is None:
            continue
        delta = score(nxt) - score(cur)
        temp = t0 * 0.5 * (1.0 - i / steps) + 1e-12
        if delta <= 0 or rng.random() < math.exp(-delta / temp):
            cur = nxt


def _search(cands: list, model: LatencyModel, geom: LayerGeometry,
            trials: int, seed: int, seeded: Sequence = (),
            batch: int = 1) -> tuple[list, int]:
    """Rank the design space under the model.  Returns (cheapest-first
    plans the search scored, number scored).  ``seeded`` plans are always
    in the scored pool — the heuristic rides here, so a sampled search
    can never rank the winner modeled-worse than the heuristic."""
    if len(cands) <= trials:
        pool = list(cands) + [p for p in seeded if p not in cands]
        return model.rank(pool, geom, batch=batch), len(cands)
    rng = random.Random(seed)
    pool = rng.sample(cands, trials)
    scores = {p: model.layer_seconds(p, geom, batch=batch)
              for p in list(pool) + list(seeded)}

    def order(p):
        return scores[p], *plan_order(p)

    _anneal(cands, scores, model, geom, rng, min(scores, key=order),
            steps=2 * trials, batch=batch)
    return sorted(scores, key=order), len(scores)


# ---------------------------------------------------------------------------
# Measurement: pin one candidate, time the real kernel.
# ---------------------------------------------------------------------------

def _measurement_layer(geom: LayerGeometry):
    """The one-layer network a candidate is measured on: the geometry
    itself with no padding or crop (its plan key is the geometry's)."""
    from repro_torch.core import networks as _networks

    return _networks.UniformLayer(
        name="tune.probe", in_spatial=geom.in_spatial, cin=geom.cin,
        cout=geom.cout, kernel=geom.kernel, stride=geom.stride,
        padding=0, op=geom.mode, groups=geom.groups,
        dilation=geom.dilation)


def operand_policy(geom: LayerGeometry):
    """``(dtype, Precision)`` that make a layer launch at the geometry's
    operand widths: f32 or bf16 float operands, int8 weights
    (``weight_quant``), int8 activations (``act_quant``, f32 storage)."""
    from repro_torch.quant import Precision

    pairs = {(4, 4): (torch.float32, Precision()),
             (2, 2): (torch.bfloat16, Precision()),
             (4, 1): (torch.float32, Precision(weight_quant="int8")),
             (2, 1): (torch.bfloat16, Precision(weight_quant="int8")),
             (1, 1): (torch.float32, Precision(weight_quant="int8",
                                               act_quant="int8"))}
    key = (geom.in_dtype_bytes, geom.w_dtype_bytes)
    if key not in pairs:
        raise ValueError(f"no operand pair of widths {key} runs on the "
                         f"kernels")
    return pairs[key]


def measure_plan(plan: _tiling.DeconvTilePlan, geom: LayerGeometry, *,
                 smem_budget: int = _tiling.SMEM_BUDGET, repeats: int = 3,
                 seed: int = 0, batch: int = 1, device="cuda") -> float:
    """Best-of-``repeats`` seconds of the geometry's forward under
    ``plan`` at ``batch``: pinned through a single-entry tuned cache,
    timed by ``obs.measure_network`` (one layer), the operands at the
    geometry's own widths (``operand_policy``; int8 weights from
    ``quant.quantize_weights``, int8 activations quantized by the engine
    on the device)."""
    from repro_torch import obs
    from repro_torch.core import engine as _engine
    from repro_torch.quant import quantize_weights

    pin = TunedPlanCache()
    pin.put(geom.key_tuple, plan, winner_source="model")
    dtype, prec = operand_policy(geom)
    eng = _engine.UniformEngine(_engine.EngineConfig(
        max_tile_bytes=smem_budget, tuned_plans=pin, precision=prec,
        device=device))
    layer = _measurement_layer(geom)
    ws = quantize_weights(_engine.init_network_weights(
        [layer], torch.Generator().manual_seed(seed)), prec)
    rpt = obs.measure_network([layer], eng, ws=ws, batch=batch,
                              repeats=repeats, peak_gflops=1.0,
                              name="tune.probe", seed=seed, dtype=dtype)
    if eng.plan_sources["tuned"] < 1:
        raise RuntimeError("the measurement engine fell back to the "
                           "heuristic: the tuner's plan key and "
                           "UniformEngine.plan's disagree")
    return rpt.layers[0].measured_s


# ---------------------------------------------------------------------------
# The tuner.
# ---------------------------------------------------------------------------

def tune_layer(geom: LayerGeometry, *,
               smem_budget: int = _tiling.SMEM_BUDGET,
               trials: int = 64, measure_topk: int = 3, repeats: int = 3,
               seed: int = 0, model: LatencyModel | None = None,
               batch: int = 1, device="cuda") -> TuneResult:
    """Tune one geometry: enumerate, search, measure the top-k, pick.

    Deterministic for a fixed ``(geometry, seed, batch)`` when
    ``measure_topk=0`` (model-only); with measurement the winner is the
    fastest measured among the model's top-k and the heuristic's plan —
    so a tuned plan is never slower than the heuristic beyond the
    timer's spread.
    """
    model = model if model is not None else LatencyModel()
    heuristic = _tiling.plan_uniform_tiles(
        geom.cin, geom.cout, mode=geom.mode, smem_budget=smem_budget,
        groups=geom.groups, in_dtype_bytes=geom.in_dtype_bytes,
        w_dtype_bytes=geom.w_dtype_bytes)
    cands = distinct_launches(candidate_plans(geom, smem_budget=smem_budget),
                              geom, batch=batch)
    ranked, scored = _search(cands, model, geom, trials, seed,
                             seeded=() if heuristic.overflows
                             else (heuristic,), batch=batch)

    measured: dict[str, float] = {}
    if measure_topk > 0 and not heuristic.overflows:
        topk = list(ranked[:measure_topk])
        if heuristic not in topk:
            topk.append(heuristic)
        walls = {}
        for plan in topk:
            walls[plan] = measure_plan(
                plan, geom, smem_budget=smem_budget, repeats=repeats,
                seed=seed, batch=batch, device=device)
            measured[plan.describe()] = walls[plan]
        order = {p: i for i, p in enumerate(topk)}
        winner = min(walls, key=lambda p: (walls[p], order[p]))
        winner_source = ("heuristic" if winner == heuristic
                         and winner not in ranked[:measure_topk]
                         else "measured")
        measured_s = walls[winner]
        heuristic_s = walls[heuristic]
    else:
        winner = ranked[0]
        winner_source = "model"
        measured_s = heuristic_s = 0.0

    key = key_from_tuple(geom.key_tuple)
    entry = TunedEntry(
        plan=winner, modeled_s=model.layer_seconds(winner, geom,
                                                   batch=batch),
        measured_s=measured_s, heuristic_measured_s=heuristic_s,
        trials=trials, candidates=len(cands), seed=seed, batch=batch,
        winner_source=winner_source)
    return TuneResult(geometry=geom, key=key, plan=winner,
                      heuristic=heuristic, entry=entry,
                      candidates=len(cands), scored=scored,
                      measured=measured)


def network_geometries(network, *, precision=None,
                       dtype: torch.dtype = torch.float32,
                       ) -> list[LayerGeometry]:
    """The unique forward geometries of a chain or ``UniformGraph``,
    lifted to 3D exactly as ``compile_network`` plans them (conv
    geometries carry their padded input extent).

    ``precision`` (a ``repro_torch.quant.Precision``) and ``dtype`` (the
    float operands' type) set the operand widths of layers without their
    own policy, as the engine resolves them, so a sweep for an int8-weight
    deployment lands on the plan keys the engine looks up at run time.
    """
    from repro_torch.core import engine as _engine
    from repro_torch.core import networks as _networks
    from repro_torch.kernels import common as _kcommon
    from repro_torch.quant import Precision

    layers = (network.layers
              if isinstance(network, _networks.UniformGraph)
              else list(network))
    geoms, seen = [], set()
    for layer in layers:
        sp3, k3, s3, p3, dil3 = _engine._lift_geometry(layer)
        if layer.op == "conv":
            sp3 = _kcommon.padded_extent(sp3, p3)
        prec = (layer.precision if layer.precision is not None
                else precision if precision is not None else Precision())
        a_bytes, w_bytes = prec.operand_bytes(dtype)
        geom = LayerGeometry(
            mode=layer.op, in_spatial=sp3, kernel=k3, stride=s3,
            cin=layer.cin, cout=layer.cout, groups=layer.groups,
            dilation=dil3, in_dtype_bytes=a_bytes, w_dtype_bytes=w_bytes)
        if geom.key_tuple not in seen:
            seen.add(geom.key_tuple)
            geoms.append(geom)
    return geoms


def tune_network(network, *,
                 smem_budget: int = _tiling.SMEM_BUDGET,
                 trials: int = 64, measure_topk: int = 3, repeats: int = 3,
                 seed: int = 0, model: LatencyModel | None = None,
                 batch: int = 1, device="cuda", precision=None,
                 dtype: torch.dtype = torch.float32,
                 cache: TunedPlanCache | None = None,
                 ) -> tuple[TunedPlanCache, list[TuneResult]]:
    """Tune every unique geometry of a network once into ``cache``.

    Geometries already in the given cache are skipped — the "pay once per
    geometry, ever" contract: a sweep over an existing cache only
    searches what is new.  ``precision`` and ``dtype`` as in
    ``network_geometries``.
    """
    cache = cache if cache is not None else TunedPlanCache()
    results = []
    for geom in network_geometries(network, precision=precision,
                                   dtype=dtype):
        key = key_from_tuple(geom.key_tuple)
        if cache.get(key) is not None:
            continue
        res = tune_layer(geom, smem_budget=smem_budget, trials=trials,
                         measure_topk=measure_topk, repeats=repeats,
                         seed=seed, model=model, batch=batch, device=device)
        cache.entries[key] = res.entry
        results.append(res)
    return cache, results
