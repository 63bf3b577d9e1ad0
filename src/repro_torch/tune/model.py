"""Analytic latency model of one Hopper forward launch, and the tuner's
design space (the JAX package's ``tune/model.py`` on the Hopper planner).

The autotuner ranks candidate ``DeconvTilePlan``s with a roofline plus
overheads:

    seconds(plan) = max(padded_flops / the route's roof,
                        gathered_bytes / bandwidth)
                    + waves * wave_overhead + launches * launch_overhead

where the terms come from ``tiling.plan_cost_terms`` (the wrappers' own
launch arithmetic: rows padded to the tile, the split's slices, the
second pass of a split launch) and the machine constants default to the
H100 data sheet (``tiling.NOMINAL_*``).  ``LatencyModel.calibrate``
replaces the f32 roof and the bandwidth with the ``repro_torch.obs``
probes.  The model only has to rank; measurement picks.

``candidate_plans`` is the tuner's view of the design space: the route's
four tiles under both split policies, each within the budget
(``tiling.candidate_tile_plans``, one enumeration with the planner's own
byte model).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import tiling as _tiling


@dataclasses.dataclass(frozen=True)
class LayerGeometry:
    """One plannable forward geometry — the tuner's unit of work.

    Spatial fields are the lifted 3D extents the engine plans with; for
    ``mode="conv"`` the extent is the padded input, as the engine keys it.
    ``in_dtype_bytes`` / ``w_dtype_bytes`` are the operands' real widths
    (4 f32, 2 bf16, 1 int8; ``None`` weights: the activations' width).
    """
    mode: str                        # "deconv" | "conv"
    in_spatial: tuple[int, ...]
    kernel: tuple[int, ...]
    stride: tuple[int, ...]
    cin: int
    cout: int
    groups: int = 1
    dilation: tuple[int, ...] = ()
    in_dtype_bytes: int = 4
    w_dtype_bytes: int | None = None

    def __post_init__(self):
        for f in ("in_spatial", "kernel", "stride"):
            object.__setattr__(self, f, tuple(getattr(self, f)))
        dil = self.dilation or (1,) * len(self.in_spatial)
        object.__setattr__(self, "dilation", tuple(dil))
        if self.w_dtype_bytes is None:
            object.__setattr__(self, "w_dtype_bytes",
                               int(self.in_dtype_bytes))

    @property
    def key_tuple(self) -> tuple:
        """The engine's plan-cache key of this geometry
        (``UniformEngine.plan``)."""
        return (self.mode, self.in_spatial, self.kernel, self.stride,
                int(self.cin), int(self.cout), int(self.groups),
                self.dilation, int(self.in_dtype_bytes),
                int(self.w_dtype_bytes))

    @property
    def route(self) -> str:
        return _tiling.operand_route(self.in_dtype_bytes, self.w_dtype_bytes)

    def describe(self) -> str:
        from repro_torch.tune.cache import key_from_tuple
        return key_from_tuple(self.key_tuple)


@dataclasses.dataclass(frozen=True)
class LatencyModel:
    """Roofline-with-overheads scorer for candidate plans, in seconds:
    ``peak_flops`` is the f32 (``"fma"``) route's roof, ``tf32_flops``,
    ``bf16_flops`` and ``int8_ops`` the tensor-core routes'."""
    peak_flops: float = _tiling.NOMINAL_ROUTE_FLOPS["fma"]
    tf32_flops: float = _tiling.NOMINAL_ROUTE_FLOPS["tf32"]
    int8_ops: float = _tiling.NOMINAL_ROUTE_FLOPS["s8"]
    bf16_flops: float = _tiling.NOMINAL_ROUTE_FLOPS["bf16"]
    mem_bps: float = _tiling.NOMINAL_MEM_BPS
    wave_overhead_s: float = _tiling.NOMINAL_WAVE_OVERHEAD_S
    launch_overhead_s: float = _tiling.NOMINAL_LAUNCH_OVERHEAD_S

    @classmethod
    def calibrate(cls, device="cuda", **overrides) -> "LatencyModel":
        """The f32 roof and the bandwidth from the live ``repro_torch.obs``
        probes on ``device`` (or the ``REPRO_PEAK_GFLOPS`` /
        ``REPRO_MEM_GBPS`` overrides); the tensor-core roofs stay
        nominal."""
        from repro_torch import obs

        kw = {"peak_flops": obs.machine_peak_gflops(device=device) * 1e9,
              "mem_bps": obs.machine_mem_gbps(device=device) * 1e9}
        kw.update(overrides)
        return cls(**kw)

    @property
    def route_flops(self) -> dict:
        return {"fma": self.peak_flops, "tf32": self.tf32_flops,
                "s8": self.int8_ops, "bf16": self.bf16_flops}

    def layer_seconds(self, plan: _tiling.DeconvTilePlan,
                      geom: LayerGeometry, *, batch: int = 1) -> float:
        """Modeled seconds of one layer forward under ``plan``."""
        terms = _tiling.plan_cost_terms(
            plan, geom.in_spatial, geom.kernel, geom.stride, geom.cin,
            geom.cout, mode=geom.mode, groups=geom.groups,
            dilation=geom.dilation, in_dtype_bytes=geom.in_dtype_bytes,
            w_dtype_bytes=geom.w_dtype_bytes, batch=batch)
        return _tiling.modeled_cost(
            terms, route_flops=self.route_flops, mem_bps=self.mem_bps,
            wave_overhead_s=self.wave_overhead_s,
            launch_overhead_s=self.launch_overhead_s)

    def rank(self, plans, geom: LayerGeometry, *, batch: int = 1):
        """Plans sorted cheapest-first; ties broken on the plan's tile and
        split policy, so equal-cost candidates order stably."""
        return sorted(plans, key=lambda p: (
            self.layer_seconds(p, geom, batch=batch), *plan_order(p)))


def plan_order(plan: _tiling.DeconvTilePlan) -> tuple:
    """A plan's coordinates in the design space, the tie-break order."""
    return plan.block_co, _tiling.SPLIT_POLICIES.index(plan.split)


def distinct_launches(plans, geom: LayerGeometry, *, batch: int = 1):
    """``plans`` less those that launch what an earlier one launches at
    ``batch``: where ``split="auto"`` gives one slice, ``"off"`` is the
    same launch, so only the first plan of each (tile, slices) pair is
    kept (``candidate_plans`` lists ``"auto"`` first, so the heuristic's
    plan stays)."""
    seen, out = set(), []
    for p in plans:
        terms = _tiling.plan_cost_terms(
            p, geom.in_spatial, geom.kernel, geom.stride, geom.cin,
            geom.cout, mode=geom.mode, groups=geom.groups,
            dilation=geom.dilation, in_dtype_bytes=geom.in_dtype_bytes,
            w_dtype_bytes=geom.w_dtype_bytes, batch=batch)
        sig = (p.block_co, terms["splits"])
        if sig not in seen:
            seen.add(sig)
            out.append(p)
    return out


def candidate_plans(geom: LayerGeometry, *,
                    smem_budget: int = _tiling.SMEM_BUDGET):
    """The design space of one geometry, every point within
    ``smem_budget`` (``tiling.candidate_tile_plans``)."""
    return _tiling.candidate_tile_plans(
        geom.cin, geom.cout, mode=geom.mode, smem_budget=smem_budget,
        groups=geom.groups, in_dtype_bytes=geom.in_dtype_bytes,
        w_dtype_bytes=geom.w_dtype_bytes)
