"""repro_torch.tune — search-based autotuning of the Hopper tile plans,
remembered forever (the JAX package's ``repro.tune``).

Replaces "plan once by heuristic" with "search once per geometry":

  * ``model`` — the analytic latency model of one forward launch (per
    route roofs, waves, the split's second launch) and the design space:
    each route's four tiles x the two split policies, within the budget.
  * ``search`` — the seeded tuner: exhaustive (or random sweep +
    simulated annealing) search under the model, measurement of the
    top-k and the heuristic on the card, ``tune_network`` over whole
    chains and DAGs.
  * ``cache`` — the versioned, geometry-keyed ``TunedPlanCache``
    persisted to JSON; ``EngineConfig(tuned_plans=cache)`` makes every
    ``UniformEngine.plan`` of a forward geometry consult it before the
    heuristic.

The sweep: ``python -m repro_torch.launch.tune``.
"""

from repro_torch.tune.cache import (
    CACHE_KIND,
    SCHEMA_VERSION,
    TunedEntry,
    TunedPlanCache,
    TunedPlanSchemaError,
    key_from_tuple,
    plan_key,
)
from repro_torch.tune.model import (
    LatencyModel,
    LayerGeometry,
    candidate_plans,
    distinct_launches,
)
from repro_torch.tune.search import (
    TuneResult,
    measure_plan,
    network_geometries,
    operand_policy,
    tune_layer,
    tune_network,
)

__all__ = [
    "CACHE_KIND",
    "SCHEMA_VERSION",
    "LatencyModel",
    "LayerGeometry",
    "TuneResult",
    "TunedEntry",
    "TunedPlanCache",
    "TunedPlanSchemaError",
    "candidate_plans",
    "distinct_launches",
    "key_from_tuple",
    "measure_plan",
    "network_geometries",
    "operand_policy",
    "plan_key",
    "tune_layer",
    "tune_network",
]
