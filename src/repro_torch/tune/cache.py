"""The persisted tuned-plan cache: search once per geometry, remember
forever (the JAX package's ``tune/cache.py`` on the Hopper planner).

A ``TunedPlanCache`` maps a canonical geometry key — the port's engine
plan-cache key of a forward geometry, field for field (mode, lifted
spatial extent, kernel, stride, channels, groups, dilation, activation
and weight widths; ``UniformEngine.plan``) — to the winning
``DeconvTilePlan`` (tile and split policy) plus its tuning provenance.
It round-trips through a versioned JSON file:

    cache, _ = tune.tune_network(graph, batch=4)   # search + measure once
    cache.save("build/tuned_plans.json")
    ...
    cache = tune.TunedPlanCache.load("build/tuned_plans.json")
    engine = UniformEngine(EngineConfig(tuned_plans=cache))
    # every engine.plan() of a tuned geometry hits the cache

The file has a schema of its own (``CACHE_KIND``, ``SCHEMA_VERSION``):
the JAX package's files key their geometries in another order and hold
TPU plans, so one of them — or a file of another version — loads as an
EMPTY cache (the engine falls back to the heuristic, a re-tune rewrites
the file), or raises ``TunedPlanSchemaError`` under ``strict=True``.

Like ``obs.Telemetry``, the cache hashes by identity so it can ride
inside the frozen ``EngineConfig``.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Iterator

from repro_torch.core import tiling as _tiling

CACHE_KIND = "hopper_tuned_plan_cache"
SCHEMA_VERSION = 1


class TunedPlanSchemaError(ValueError):
    """A tuned-plan file's kind or schema version is not this build's."""


def plan_key(mode: str, in_spatial, kernel, stride, cin: int, cout: int, *,
             groups: int = 1, dilation=None, in_dtype_bytes: int = 4,
             w_dtype_bytes: int | None = None) -> str:
    """Canonical string key of one forward geometry, built as
    ``UniformEngine.plan`` builds its key (``w_dtype_bytes=None``: the
    activations' width; ``mode="conv"``: the padded input extent)."""
    dilation = (tuple(dilation) if dilation is not None
                else (1,) * len(tuple(in_spatial)))
    w_bytes = (int(in_dtype_bytes) if w_dtype_bytes is None
               else int(w_dtype_bytes))
    return key_from_tuple((mode, tuple(in_spatial), tuple(kernel),
                           tuple(stride), int(cin), int(cout), int(groups),
                           dilation, int(in_dtype_bytes), w_bytes))


def key_from_tuple(key: tuple) -> str:
    """Stringify the engine's forward plan-cache key tuple: (mode,
    in_spatial, kernel, stride, cin, cout, groups, dilation,
    in_dtype_bytes, w_dtype_bytes)."""
    mode, sp, k, s, cin, cout, g, dil, a, wb = key

    def _x(t):
        return "x".join(str(int(v)) for v in t)

    return (f"{mode}:sp{_x(sp)}:k{_x(k)}:s{_x(s)}:ci{cin}:co{cout}"
            f":g{g}:d{_x(dil)}:a{a}:w{wb}")


@dataclasses.dataclass(frozen=True)
class TunedEntry:
    """One cached winner: the plan plus how it was found."""
    plan: _tiling.DeconvTilePlan
    modeled_s: float = 0.0           # the latency model's seconds
    measured_s: float = 0.0          # measured (0.0 = model-only tuning)
    heuristic_measured_s: float = 0.0
    trials: int = 0
    candidates: int = 0
    seed: int = 0
    batch: int = 1
    winner_source: str = "model"     # "model" | "measured" | "heuristic"

    def to_json(self) -> dict:
        return {"plan": dataclasses.asdict(self.plan),
                **{f.name: getattr(self, f.name)
                   for f in dataclasses.fields(self) if f.name != "plan"}}

    @classmethod
    def from_json(cls, d: dict) -> "TunedEntry":
        return cls(plan=_tiling.DeconvTilePlan(**d["plan"]),
                   modeled_s=float(d.get("modeled_s", 0.0)),
                   measured_s=float(d.get("measured_s", 0.0)),
                   heuristic_measured_s=float(
                       d.get("heuristic_measured_s", 0.0)),
                   trials=int(d.get("trials", 0)),
                   candidates=int(d.get("candidates", 0)),
                   seed=int(d.get("seed", 0)),
                   batch=int(d.get("batch", 1)),
                   winner_source=str(d.get("winner_source", "model")))


class TunedPlanCache:
    """Geometry-keyed store of tuned tile plans, JSON-persisted.

    ``lookup`` is the engine-facing read path: it takes the engine's raw
    key tuple, refuses plans whose shared memory exceeds the CALLER's
    budget, and counts lookups and hits so callers and tests can assert
    "zero search" without telemetry.
    """

    def __init__(self, entries: dict[str, TunedEntry] | None = None,
                 meta: dict | None = None):
        self.entries: dict[str, TunedEntry] = dict(entries or {})
        self.meta: dict = dict(meta or {})
        self.lookups = 0
        self.hits = 0

    # identity hashing — usable inside the frozen EngineConfig
    __hash__ = object.__hash__

    def __len__(self) -> int:
        return len(self.entries)

    def __iter__(self) -> Iterator[str]:
        return iter(self.entries)

    def __repr__(self):
        return (f"TunedPlanCache(entries={len(self.entries)}, "
                f"hits={self.hits}/{self.lookups})")

    # -- engine-facing read path -------------------------------------------

    def lookup(self, key: tuple, *, smem_budget: int | None = None,
               ) -> _tiling.DeconvTilePlan | None:
        self.lookups += 1
        entry = self.entries.get(key_from_tuple(key))
        if entry is None:
            return None
        if (smem_budget is not None
                and entry.plan.step_smem_bytes > smem_budget):
            return None
        self.hits += 1
        return entry.plan

    def get(self, key_str: str) -> TunedEntry | None:
        return self.entries.get(key_str)

    # -- tuner-facing write path -------------------------------------------

    def put(self, key: tuple | str, plan: _tiling.DeconvTilePlan,
            **meta) -> TunedEntry:
        key_str = key if isinstance(key, str) else key_from_tuple(key)
        entry = TunedEntry(plan=plan, **meta)
        self.entries[key_str] = entry
        return entry

    def merge(self, other: "TunedPlanCache") -> "TunedPlanCache":
        self.entries.update(other.entries)
        return self

    # -- persistence --------------------------------------------------------

    def to_json(self) -> dict:
        return {
            "schema_version": SCHEMA_VERSION,
            "kind": CACHE_KIND,
            "meta": self.meta,
            "entries": {k: e.to_json()
                        for k, e in sorted(self.entries.items())},
        }

    def save(self, path) -> pathlib.Path:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_json(), indent=1) + "\n")
        return path

    @classmethod
    def from_json(cls, payload: dict, *, strict: bool = False,
                  ) -> "TunedPlanCache":
        kind = payload.get("kind")
        version = payload.get("schema_version")
        if (kind, version) != (CACHE_KIND, SCHEMA_VERSION):
            if strict:
                raise TunedPlanSchemaError(
                    f"tuned-plan file {kind!r} v{version} is not "
                    f"{CACHE_KIND!r} v{SCHEMA_VERSION}; re-run the tuner "
                    f"to regenerate it")
            # another schema: invalidate silently — the engine falls back
            # to the heuristic and the next sweep rewrites the file
            return cls(meta={"invalidated_kind": kind,
                             "invalidated_version": version})
        return cls(entries={k: TunedEntry.from_json(e)
                            for k, e in payload.get("entries", {}).items()},
                   meta=payload.get("meta", {}))

    @classmethod
    def load(cls, path, *, strict: bool = False) -> "TunedPlanCache":
        payload = json.loads(pathlib.Path(path).read_text())
        return cls.from_json(payload, strict=strict)
