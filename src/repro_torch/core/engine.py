"""One configured engine, compiled schedules — the uniform front door.

The paper's claim is a uniform architecture: one configurable engine runs
every conv and deconv layer of 2D and 3D DCNNs from a per-layer schedule
decided at compile time.  In the port:

  * ``EngineConfig`` — the engine's configuration, decided once: method,
    the numeric ``Precision`` policy (storage dtype, int8 weights and
    activations), shared-memory budget, channel-tile overrides, telemetry,
    and the ``device`` it runs on (``"cuda"`` unless the caller asks for
    the CPU, where the kernels' plain versions run).
  * ``UniformEngine`` — ``engine.conv``/``engine.deconv`` run both
    directions on the hand-written Hopper kernels (method ``"pallas"``) or
    on a reference lowering (``"oom"``, ``"xla"``, ``"iom"``,
    ``"iom_phase"``: cuDNN and plain tensor code, the epilogue applied on
    the op output), and a geometry-keyed plan cache makes the tile
    planner run once per layer geometry, whatever the method.
  * ``compile_network(layers, engine)`` — a ``UniformLayer`` chain or a
    ``UniformGraph`` becomes (a) an eager callable running every node on
    the engine and (b) a ``ScheduleReport`` of the per-layer plans.

``engine.conv`` is a correlation (channels-last, no kernel flip):
``y[n, o, co] = sum_{k, ci} x[n, o*S + k*dil - lo, ci] * w[k, ci, co]``;
``engine.deconv`` is the paper's Eq. (1) transposed convolution with an
optional border crop.  Under ``Precision(weight_quant="int8")`` int8
weights reach the kernels as 1-byte operands with their per-cout dequant
scale fused in the epilogue; ``act_quant="int8"`` adds a per-tensor int8
quantization of each layer's input on the device, its scale folded into
the weights'.  The reference lowerings dequantize the weights up front
and fake-quantize the activations instead (``_dequant_host``).  A
``repro_torch.tune.TunedPlanCache`` in ``EngineConfig(tuned_plans=...)``
gives the planner the autotuner's measured plans first.

With ``EngineConfig(mesh=..., policy=MeshPolicy(...))`` the engine is
mesh-aware (``repro_torch.sharding.mesh``): ``compile_network`` partitions
a chain over the mesh, the batch over the data axis and, with a model
axis, the channels Megatron-style (a layer's Cout sharded, the next
layer's Cin contracted and all-reduced), and a graph over the data axis
alone.  Each rank's ``apply`` takes its shard of the batch
(``shard_batch``) and returns its shard of the output, as DDP does; the
report's rows are then per rank.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Sequence

import torch

from repro_torch.core import networks as _networks
from repro_torch.core import tiling as _tiling
from repro_torch.core.functional import (  # noqa: F401 (re-export)
    METHODS,
    PORTED_METHODS,
    conv_output_shape,
    correlate,
    deconv_iom,
    deconv_iom_phase,
    deconv_oom,
    deconv_xla,
    insertion_sparsity,
    pop_pallas_knobs,
)
from repro_torch import obs as _obs
from repro_torch import tree as _tree
from repro_torch.kernels import common as _kcommon
from repro_torch.sharding import mesh as _mesh
from repro_torch.quant import qint8 as _q8
from repro_torch.quant.precision import Precision

CONV_METHODS = ("xla", "pallas")

_XLA_DECONVS = {"oom": deconv_oom, "xla": deconv_xla, "iom": deconv_iom,
                "iom_phase": deconv_iom_phase}


def uniform_conv_method(deconv_method: str) -> str:
    """The conv side of a deconv method: ``"pallas"`` keeps the network on
    the hand kernels; every reference lowering pairs with the ``"xla"``
    conv."""
    return "pallas" if deconv_method == "pallas" else "xla"


class EngineError(Exception):
    """Base of the engine's typed failure surface."""


class ScheduleError(EngineError, ValueError):
    """A schedule could not be built or applied: broken layer chains,
    mismatched weight trees, a plan over budget, ..."""


class VmemBudgetError(ScheduleError):
    """The planned block exceeds the shared-memory budget (raised only under
    ``EngineConfig(strict_vmem=True)``).  The name is the JAX package's; on
    Hopper the budget is shared memory per block, not VMEM."""

    def __init__(self, msg: str, plan: "_tiling.DeconvTilePlan" = None):
        super().__init__(msg)
        self.plan = plan


@dataclasses.dataclass(frozen=True)
class MeshPolicy:
    """How ``compile_network`` partitions a network over the engine's mesh.

    ``batch_axis`` shards the batch dim of every activation (pure data
    parallelism).  ``model_axis``, when set, also shards channels
    Megatron-style: a layer whose ``Cout`` divides the axis computes a
    channel shard of its output, the NEXT layer contracts its sharded
    ``Cin`` and all-reduces the partial outputs (pairs alternate down the
    chain; a trailing channel-sharded output is all-gathered).  Layers
    whose channels do not divide the axis, or would fall below
    ``min_channel_block`` per rank, stay replicated.
    """
    batch_axis: str = "data"
    model_axis: str | None = None
    min_channel_block: int = 8


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The uniform engine's compile-time configuration.

    ``method`` is one of ``METHODS``: ``"pallas"`` (the hand kernels) or
    a reference lowering; the conv side pairs via
    ``uniform_conv_method``.  ``precision`` (a ``repro_torch.quant.Precision``) is the
    engine's numeric policy: activation storage dtype, int8 weight and
    activation quantization.  ``preferred_element_type`` is the legacy
    spelling of its storage dtype (``None``: the input's dtype, f32 for
    int8 inputs), normalized into an equivalent ``Precision(storage=...)``
    at construction, so both spellings make equal configs with equal
    hashes; naming both with different dtypes raises.  Accumulation is f32
    regardless.  ``max_tile_bytes`` overrides the per-block shared-memory
    budget; ``block_ci``/``block_co`` pin the kernels' tiles;
    ``strict_vmem`` turns an over-budget plan into a ``VmemBudgetError``
    (on every method: a schedule plans its layers whatever the method).
    ``telemetry`` (a ``repro_torch.obs.Telemetry``) records plan-cache and
    compile instruments and ``compile_network``'s ``compile`` and
    ``apply`` spans, and makes it count and time the host's dispatch of
    each call of its callable (``obs.instrument_apply``); the finer spans
    join them only while a profiler records (``obs.profiled``), and
    without it every span goes to a profile's recorder.  ``tuned_plans`` (a
    ``repro_torch.tune.TunedPlanCache``) is the autotuner's output: on a
    plan-cache miss of a forward geometry the engine takes its entry
    before the heuristic, unless the entry's shared memory exceeds this
    config's budget; like ``Telemetry`` it hashes by identity.  ``device``
    is where the engine runs: ``"cuda"`` by default; ``"cpu"`` runs the
    kernels' plain versions; ``"meta"`` (``"pallas"`` only) traces shapes
    alone (the dry run: the wrappers tally their calls, nothing runs).
    ``mesh`` (a ``repro_torch.sharding.mesh.Mesh``)
    makes ``compile_network`` partition its schedules per ``policy``;
    ``engine.conv``/``engine.deconv`` called directly stay one rank's.
    """
    method: str = "pallas"
    preferred_element_type: Any = None
    precision: Precision | None = None
    max_tile_bytes: int | None = None
    block_ci: int | None = None
    block_co: int | None = None
    strict_vmem: bool = False
    telemetry: Any = None
    device: Any = "cuda"
    tuned_plans: Any = None
    mesh: Any = None
    policy: MeshPolicy = MeshPolicy()

    def __post_init__(self):
        if self.method not in METHODS:
            raise ValueError(f"unknown method {self.method!r}; expected one "
                             f"of {METHODS}")
        pet = self.preferred_element_type
        if self.precision is None:
            # the compat shim: preferred_element_type=dt and
            # precision=Precision(storage=dt) are the same config
            object.__setattr__(self, "precision", Precision(storage=pet))
        elif not isinstance(self.precision, Precision):
            raise ValueError(f"precision must be a repro_torch.quant."
                             f"Precision, got {self.precision!r}")
        elif pet is not None and pet != self.precision.storage:
            raise ValueError(
                f"precision.storage={self.precision.storage} conflicts with "
                f"preferred_element_type={pet}; pass precision= alone "
                f"(preferred_element_type is the legacy spelling of "
                f"Precision(storage=...))")
        pet = self.precision.storage
        object.__setattr__(self, "preferred_element_type", pet)
        if pet is not None and pet not in (torch.float32, torch.bfloat16):
            raise ValueError(f"preferred_element_type must be float32 or "
                             f"bfloat16, got {pet!r}")
        object.__setattr__(self, "device", torch.device(self.device))
        if self.policy.model_axis == self.policy.batch_axis:
            raise ValueError(
                f"model_axis and batch_axis are both "
                f"{self.policy.batch_axis!r}: channel partials would psum "
                f"across different batch shards")
        if self.mesh is not None:
            names = self.mesh.axis_names
            if self.policy.batch_axis not in names:
                raise ValueError(
                    f"batch_axis {self.policy.batch_axis!r} not in mesh "
                    f"axes {names}")
            if (self.policy.model_axis is not None
                    and self.policy.model_axis not in names):
                raise ValueError(
                    f"model_axis {self.policy.model_axis!r} not in mesh "
                    f"axes {names}")

    @property
    def conv_method(self) -> str:
        return uniform_conv_method(self.method)

    @property
    def smem_budget(self) -> int:
        return self.max_tile_bytes or _tiling.SMEM_BUDGET


class UniformEngine:
    """The configured engine: both op directions + a compiled plan cache.

        engine = UniformEngine(method="pallas")          # on the card
        y = engine.deconv(x, w, stride=2, padding=((0, 1), (0, 1)))
        h = engine.conv(y, w2, stride=2, padding=1)

    Constructing an engine for ``"cuda"`` with no CUDA device raises: the
    engine never carries on quietly on the CPU.
    """

    def __init__(self, config: EngineConfig | str | None = None, **overrides):
        if config is None:
            config = EngineConfig(**overrides)
        elif isinstance(config, str):
            config = EngineConfig(method=config, **overrides)
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        if not isinstance(config, EngineConfig):
            raise TypeError(f"expected EngineConfig | method name, got "
                            f"{config!r}")
        if config.device.type == "cuda" and not torch.cuda.is_available():
            raise EngineError("no CUDA device is available; pass "
                              "device='cpu' to run the kernels' plain "
                              "versions on the CPU")
        if config.device.type not in ("cuda", "cpu") and not (
                config.device.type == "meta" and config.method == "pallas"):
            raise EngineError(f"unsupported device {config.device} for "
                              f"{config.method!r}")
        self.config = config
        self.device = config.device
        self._plans: dict[tuple, _tiling.DeconvTilePlan] = {}
        # where each plan-cache miss took its plan from: the tuned cache or
        # the heuristic (telemetry's source counters, without telemetry)
        self.plan_sources: dict[str, int] = {"tuned": 0, "heuristic": 0}

    def __repr__(self):
        return (f"UniformEngine({self.config!r}, "
                f"cached_plans={len(self._plans)})")

    @property
    def plan_cache(self) -> dict:
        """Read-only view of the geometry-keyed schedule cache."""
        return dict(self._plans)

    def plan(self, mode: str, in_spatial, kernel, stride, cin: int, cout: int,
             *, groups: int = 1, dilation=None, in_dtype_bytes: int = 4,
             w_dtype_bytes: int | None = None, backward: bool = False,
             rows: int | None = None):
        """The engine's only path to the tile planner — geometry-memoized.

        ``mode="conv"`` takes the padded input extent, as the JAX planner
        does.  A forward geometry's miss takes the ``tuned_plans`` entry
        for its key when there is one within the budget, else runs the
        heuristic (``plan_sources``; with telemetry the
        ``engine_plan_tuned_hits_total`` / ``engine_plan_heuristic_total``
        counters).  ``backward=True`` plans the layer's backward instead
        (a ``BackwardPlan``: the dx launch on the other forward kernel and
        the dw kernel), keyed apart from the forward as the JAX package
        keys it, always by the heuristic.  ``rows`` is then the dw
        reduction's length — the batch times the positions of the
        unstrided operand (x for a deconv, dy for a conv) — which sets the
        split of the reduction.
        """
        dilation = (tuple(dilation) if dilation is not None
                    else (1,) * len(tuple(in_spatial)))
        w_bytes = (int(in_dtype_bytes) if w_dtype_bytes is None
                   else int(w_dtype_bytes))
        if backward and rows is None:
            raise ValueError("a backward plan needs the dw reduction's rows")
        key = (mode, tuple(in_spatial), tuple(kernel), tuple(stride),
               int(cin), int(cout), int(groups), dilation,
               int(in_dtype_bytes), w_bytes)
        if backward:
            key += (True, int(rows))
        plan = self._plans.get(key)
        tel = self.config.telemetry
        if plan is None:
            cfg = self.config
            t0 = time.perf_counter()
            tuned = None
            if cfg.tuned_plans is not None and not backward:
                tuned = cfg.tuned_plans.lookup(key,
                                               smem_budget=cfg.smem_budget)
            if tuned is not None:
                # the autotuner measured this geometry: its winner, no
                # heuristic work
                plan = tuned
            elif backward:
                # dx: the other forward kernel, channel roles swapped
                dx = _tiling.plan_uniform_tiles(
                    int(cout), int(cin),
                    mode="conv" if mode == "deconv" else "deconv",
                    smem_budget=cfg.smem_budget, groups=groups,
                    in_dtype_bytes=in_dtype_bytes,
                    w_dtype_bytes=in_dtype_bytes)
                a, b = (cin, cout) if mode == "deconv" else (cout, cin)
                dw = _tiling.plan_dw_tiles(
                    int(a), int(b), math.prod(kernel), int(rows),
                    groups=groups, dtype_bytes=int(in_dtype_bytes))
                plan = _tiling.BackwardPlan(dx=dx, dw=dw)
            else:
                plan = _tiling.plan_uniform_tiles(
                    int(cin), int(cout), mode=mode,
                    smem_budget=cfg.smem_budget, block_ci=cfg.block_ci,
                    block_co=cfg.block_co, groups=groups,
                    in_dtype_bytes=in_dtype_bytes, w_dtype_bytes=w_bytes)
            self._plans[key] = plan
            self.plan_sources["tuned" if tuned is not None
                              else "heuristic"] += 1
            if tel is not None:
                tel.registry.counter("engine_plan_cache_misses_total").inc()
                tel.registry.counter(
                    "engine_plan_tuned_hits_total" if tuned is not None
                    else "engine_plan_heuristic_total").inc()
                tel.registry.histogram("engine_plan_seconds").observe(
                    time.perf_counter() - t0)
        elif tel is not None:
            tel.registry.counter("engine_plan_cache_hits_total").inc()
        if self.config.strict_vmem and plan.overflows:
            raise VmemBudgetError(
                f"{mode} {tuple(in_spatial)}x{cin}->{cout}: plan "
                f"{plan.describe()} exceeds the {plan.smem_budget}-byte "
                f"shared-memory budget", plan)
        return plan

    # -- the two op directions ---------------------------------------------

    def _act_quant(self, x: torch.Tensor, w_scale,
                   precision: Precision | None):
        """Dynamic per-tensor int8 activation quantization (forward only).

        Under ``Precision(act_quant="int8")`` a float activation is
        absmax-quantized on its device and its scalar scale (a 0-dim
        device tensor, no host sync) folds into the weight dequant scale,
        so the kernel's one epilogue multiply undoes both.  Integer inputs
        pass through (already quantized).  Returns ``(x, w_scale)``.
        """
        prec = precision if precision is not None else self.config.precision
        if prec.act_quant != "int8" or not x.dtype.is_floating_point:
            return x, w_scale
        s = _q8.absmax_scale(x)
        return _q8.quantize_q8(x, s), (s if w_scale is None
                                       else w_scale * s)

    @staticmethod
    def _dequant_host(x: torch.Tensor, w: torch.Tensor, w_scale,
                      precision: Precision | None):
        """The reference lowerings' numerics for quantized operands:
        dequantize the weights up front (the per-cout scale commutes with
        the contraction, so this equals the kernels' epilogue scale) and
        fake-quantize float activations when the policy asks.  Integer
        activations become f32 as they are, unscaled, as in the JAX
        package."""
        if not w.dtype.is_floating_point:
            w = w.to(torch.float32)
            if w_scale is not None:
                w = w * w_scale.to(w.device)
        elif w_scale is not None:
            w = w * w_scale.to(device=w.device, dtype=w.dtype)
        if precision is not None and precision.act_quant == "int8" \
                and x.dtype.is_floating_point:
            s = _q8.absmax_scale(x)
            x = _q8.dequantize_int8(_q8.quantize_q8(x, s), s).to(x.dtype)
        if not x.dtype.is_floating_point:
            x = x.to(torch.float32)
        return x, w

    def deconv(self, x: torch.Tensor, w: torch.Tensor, stride, padding=0, *,
               dilation=1, groups: int = 1, bias: torch.Tensor | None = None,
               activation: str = "none", alpha: float = 0.2,
               w_scale: torch.Tensor | None = None,
               precision: Precision | None = None) -> torch.Tensor:
        """Transposed convolution (Eq. (1) + border crop).

        On ``"pallas"`` it runs the deconv kernel, epilogue fused;
        ``w_scale`` is the per-cout (or scalar) dequant scale of int8
        weights, applied in the kernel's epilogue before the store cast.
        A reference lowering dequantizes up front, applies the epilogue on
        its output and routes grouped or dilated layers through
        ``deconv_xla``; it returns the configured storage dtype, f32 when
        none is set.  ``precision`` overrides the config's policy for this
        call (``compile_network`` passes per-layer overrides)."""
        cfg = self.config
        if cfg.method == "pallas":
            from repro_torch.kernels.deconv import ops as _dops  # lazy
            x, w_scale = self._act_quant(x, w_scale, precision)
            return _dops.deconv(x, w, stride, padding, dilation=dilation,
                                groups=groups, bias=bias,
                                activation=activation, alpha=alpha,
                                w_scale=w_scale, engine=self)
        x, w = self._dequant_host(
            x, w, w_scale,
            precision if precision is not None else cfg.precision)
        pet = (cfg.preferred_element_type
               if cfg.preferred_element_type is not None else torch.float32)
        dil = _kcommon.canon_dilation(dilation, x.dim() - 2)
        if groups == 1 and all(d == 1 for d in dil):
            y = _XLA_DECONVS[cfg.method](x, w, stride, padding,
                                         preferred_element_type=pet)
        else:
            y = deconv_xla(x, w, stride, padding, dilation=dil,
                           groups=groups, preferred_element_type=pet)
        if bias is not None or activation != "none":
            y = _kcommon.apply_epilogue(y, bias, activation, alpha)
        return y

    def conv(self, x: torch.Tensor, w: torch.Tensor, stride=1, padding=0, *,
             dilation=1, groups: int = 1, bias: torch.Tensor | None = None,
             activation: str = "none", alpha: float = 0.2,
             w_scale: torch.Tensor | None = None,
             precision: Precision | None = None) -> torch.Tensor:
        """Forward strided convolution (the same epilogue, grouping,
        dilation and quantization conventions as ``deconv``).  The
        ``"xla"`` conv accumulates f32 and returns the input dtype, or the
        configured storage dtype."""
        cfg = self.config
        if cfg.conv_method == "pallas":
            from repro_torch.kernels.conv import ops as _cops  # lazy
            x, w_scale = self._act_quant(x, w_scale, precision)
            return _cops.conv(x, w, stride, padding, dilation=dilation,
                              groups=groups, bias=bias,
                              activation=activation, alpha=alpha,
                              w_scale=w_scale, engine=self)
        x, w = self._dequant_host(
            x, w, w_scale,
            precision if precision is not None else cfg.precision)
        pet, out_dtype = cfg.preferred_element_type, None
        if pet is None:
            # the kernels' contract: accumulate in f32, emit the input
            # dtype (bf16 inputs must not accumulate in bf16)
            pet, out_dtype = torch.float32, torch.promote_types(x.dtype,
                                                                w.dtype)
        y = correlate(x, w, stride, padding, dilation=dilation,
                      groups=groups).to(pet)
        if bias is not None or activation != "none":
            # the epilogue on the accumulator dtype, then the storage cast,
            # as in the kernels' flush
            y = _kcommon.apply_epilogue(y, bias, activation, alpha)
        return y if out_dtype is None else y.to(out_dtype)

    def __call__(self, layer: _networks.UniformLayer, x: torch.Tensor,
                 w: torch.Tensor, b: torch.Tensor | None = None, *,
                 w_scale: torch.Tensor | None = None) -> torch.Tensor:
        """Run one ``UniformLayer`` (op-dispatched, epilogue fused, the
        layer's precision override applied)."""
        op = self.deconv if layer.op == "deconv" else self.conv
        epi = layer.epilogue
        return op(x, w, layer.stride, layer.padding,
                  dilation=layer.dilation, groups=layer.groups, bias=b,
                  activation=epi.activation, alpha=epi.alpha,
                  w_scale=w_scale, precision=layer.precision)


# ---------------------------------------------------------------------------
# Default engines.
# ---------------------------------------------------------------------------

_DEFAULT_ENGINES: dict[EngineConfig, UniformEngine] = {}


def default_engine(config: EngineConfig | None = None,
                   **overrides) -> UniformEngine:
    """Memoized engine per ``EngineConfig``, so callers that pass no engine
    share one plan cache per configuration."""
    if config is None:
        config = EngineConfig(**overrides)
    elif overrides:
        config = dataclasses.replace(config, **overrides)
    engine = _DEFAULT_ENGINES.get(config)
    if engine is None:
        engine = _DEFAULT_ENGINES[config] = UniformEngine(config)
    return engine


def as_engine(engine, default_method: str = "pallas") -> UniformEngine:
    """Coerce ``UniformEngine | EngineConfig | method-name | None`` (a
    method name gets the memoized default engine for it, on the card)."""
    if engine is None:
        return default_engine(method=default_method)
    if isinstance(engine, UniformEngine):
        return engine
    if isinstance(engine, EngineConfig):
        return default_engine(engine)
    if isinstance(engine, str):
        return default_engine(method=engine)
    raise TypeError(f"expected UniformEngine | EngineConfig | method name, "
                    f"got {engine!r}")


def conv_nd(x: torch.Tensor, w: torch.Tensor, stride=1, padding=0,
            method: str = "xla", *, device="cuda", **kw) -> torch.Tensor:
    """Uniform 1D/2D/3D strided convolution on the memoized default engine
    for ``method`` on ``device``; new code configures a ``UniformEngine``
    once and calls ``engine.conv``.  x: [N, *spatial, Cin], w:
    [*K, Cin, Cout]; ``padding`` is a scalar, per-dim scalars or per-dim
    ``(lo, hi)`` pairs."""
    if method not in CONV_METHODS:
        raise ValueError(f"unknown method {method!r}; expected one of "
                         f"{CONV_METHODS}")
    pet = kw.pop("preferred_element_type", None)
    knobs = pop_pallas_knobs(kw, method=method, op="conv_nd")
    engine = default_engine(method=method, preferred_element_type=pet,
                            device=device, **knobs)
    return engine.conv(x, w, stride, padding)


# ---------------------------------------------------------------------------
# Compiled schedules — the paper's per-layer mapping tables, as data.
# ---------------------------------------------------------------------------

def _lift_geometry(layer: _networks.UniformLayer):
    """Mirror ``kernels.common.lift_3d`` on the layer GEOMETRY."""
    sp, k, s = layer.in_spatial, layer.kernel, layer.stride
    rank = layer.rank
    return (_kcommon.lift_tuple3(sp, rank), _kcommon.lift_tuple3(k, rank),
            _kcommon.lift_tuple3(s, rank),
            _kcommon.lift_padding(layer.padding, rank),
            _kcommon.lift_tuple3(layer.dilation, rank))


@dataclasses.dataclass(frozen=True)
class LayerSchedule:
    """One row of the compiled schedule — the per-layer mapping decision.

    Merge nodes get rows too (``op`` is the merge kind, ``plan`` is None,
    zero blocks), so the report lists every node the callable executes.
    Under a mesh the plan, blocks, shared memory and MACs are one rank's:
    its channel shard (``local_cin``/``local_cout``) at its batch, and
    ``collective_bytes`` is the payload it hands the layer's collective.
    """
    name: str
    op: str                            # "deconv" | "conv" | "concat" | "add"
    in_spatial: tuple[int, ...]
    out_spatial: tuple[int, ...]
    cin: int
    cout: int
    kernel: tuple[int, ...]
    stride: tuple[int, ...]
    plan: _tiling.DeconvTilePlan | None
    blocks: int                        # CUDA blocks of the forward launch
                                       # (its reduction slices counted)
    smem_bytes: int                    # modeled shared memory per block
    macs: int                          # valid MACs at the schedule's batch
    sparsity: float                    # zeros an OOM engine would read
    groups: int = 1
    dilation: tuple[int, ...] = ()
    epilogue: str = "-"
    dtype: str = "float32"
    splits: int = 1                    # slices of the forward's reduction
    precision: str = "f32"             # resolved Precision.describe()
    local_cin: int = 0                 # one rank's channels (0: all)
    local_cout: int = 0
    collective: str | None = None      # "psum" | "all_gather" | None
    collective_bytes: int = 0          # per-rank payload entering it

    def __post_init__(self):
        if not self.local_cin:
            object.__setattr__(self, "local_cin", self.cin)
        if not self.local_cout:
            object.__setattr__(self, "local_cout", self.cout)

    def describe(self) -> str:
        plan = self.plan.describe() if self.plan is not None else "merge"
        if self.splits > 1:
            plan += f"_split{self.splits}"
        coll = (f" {self.collective}{self.collective_bytes}B"
                if self.collective else "")
        return (f"{self.name:<18s} {self.op:<6s} "
                f"{'x'.join(map(str, self.in_spatial)):>11s}x{self.cin:<4d}-> "
                f"{'x'.join(map(str, self.out_spatial)):>11s}x{self.cout:<4d} "
                f"g{self.groups:<3d} "
                f"d{'x'.join(map(str, self.dilation)):<5s} "
                f"ep:{self.epilogue:<10s} {self.dtype:<9s} "
                f"pr:{self.precision:<13s} "
                f"{plan:<32s} blocks{self.blocks:>7d} "
                f"zeros{self.sparsity:.0%}{coll}")


@dataclasses.dataclass(frozen=True)
class ScheduleReport:
    """The whole network's compiled schedule at batch ``batch``.

    Under a mesh ``batch`` is the global batch and the rows are one rank's
    (``per_device_batch``); the cross-rank traffic is exactly the channel
    partition's collectives listed per row (``collective_bytes``)."""
    engine: EngineConfig
    layers: tuple[LayerSchedule, ...]
    batch: int = 1
    data_parallel: int = 1             # batch-axis mesh extent
    model_parallel: int = 1            # model-axis mesh extent (1 = off)

    @property
    def blocks(self) -> int:
        return sum(l.blocks for l in self.layers)

    @property
    def macs(self) -> int:
        return sum(l.macs for l in self.layers)

    @property
    def peak_smem_bytes(self) -> int:
        return max(l.smem_bytes for l in self.layers)

    @property
    def unique_plans(self) -> int:
        return len({l.plan for l in self.layers if l.plan is not None})

    @property
    def collective_bytes(self) -> int:
        """Per-rank payload bytes entering collectives, per forward."""
        return sum(l.collective_bytes for l in self.layers)

    @property
    def per_device_batch(self) -> int:
        return self.batch // self.data_parallel

    @property
    def kernel_launches(self) -> int:
        """Hand-kernel launches per forward: one per layer node with work
        (blocks) on ``"pallas"``, none on a reference lowering."""
        if self.engine.method != "pallas":
            return 0
        return sum(l.blocks > 0 for l in self.layers)

    def describe(self) -> str:
        head = (f"schedule[{self.engine.method}@{self.engine.device}] "
                f"batch={self.batch} layers={len(self.layers)} "
                f"plans={self.unique_plans} blocks={self.blocks} "
                f"macs={self.macs} peak_smem={self.peak_smem_bytes}")
        if self.data_parallel * self.model_parallel > 1:
            head += (f" mesh=dp{self.data_parallel}xmp{self.model_parallel} "
                     f"coll_bytes={self.collective_bytes}")
        return "\n".join([head] + ["  " + l.describe() for l in self.layers])


def _schedule_layer(layer: _networks.UniformLayer, engine: UniformEngine,
                    batch: int, dtype: torch.dtype, *,
                    local_cin: int | None = None,
                    local_cout: int | None = None,
                    collective: str | None = None,
                    collective_bytes: int = 0) -> LayerSchedule:
    full = layer
    if local_cin or local_cout:
        # the plan one rank runs: its channel shard
        layer = dataclasses.replace(layer, cin=local_cin or layer.cin,
                                    cout=local_cout or layer.cout)
    g = layer.groups
    sp3, k3, s3, p3, dil3 = _lift_geometry(layer)
    # the resolved policy (the layer's override, else the config's) sets
    # the operand widths the planner charges: 1 byte for an int8 operand,
    # as the op will plan it at its launch
    prec = (layer.precision if layer.precision is not None
            else engine.config.precision)
    a_bytes, w_bytes = prec.operand_bytes(dtype)
    key_sp = _kcommon.padded_extent(sp3, p3) if layer.op == "conv" else sp3
    plan = engine.plan(layer.op, key_sp, k3, s3, layer.cin, layer.cout,
                       groups=g, dilation=dil3, in_dtype_bytes=a_bytes,
                       w_dtype_bytes=w_bytes)
    rows, phases, depth = _tiling.launch_shape(
        layer.op, key_sp, k3, s3, layer.cin, groups=g, dilation=dil3,
        batch=batch)
    sparsity = (insertion_sparsity(layer.in_spatial, layer.kernel,
                                   layer.stride)
                if layer.op == "deconv" else 0.0)
    splits, _ = _tiling.launch_split(plan, rows, depth, layer.cout, g,
                                     phases)
    blocks = _tiling.grid_blocks(plan, rows, layer.cout, g, phases, splits)
    if layer.empty:
        # a window with no sum: the op returns without a launch
        splits = blocks = 0
    return LayerSchedule(
        name=layer.name, op=layer.op, in_spatial=layer.in_spatial,
        out_spatial=layer.out_spatial, cin=full.cin, cout=full.cout,
        local_cin=layer.cin, local_cout=layer.cout, collective=collective,
        collective_bytes=collective_bytes,
        kernel=layer.kernel, stride=layer.stride, plan=plan, blocks=blocks,
        smem_bytes=plan.step_smem_bytes,
        macs=0 if layer.empty else batch * layer.valid_macs,
        sparsity=sparsity, groups=g, dilation=layer.dilation,
        epilogue=layer.epilogue.describe(), dtype=_dtype_name(dtype),
        splits=splits, precision=prec.describe())


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[-1]


def _schedule_merge(node: _networks.MergeNode, graph: _networks.UniformGraph,
                    dtype: torch.dtype) -> LayerSchedule:
    sp, cout = graph.node_shape(node.name)
    cin = sum(graph.node_shape(p)[1] for p in graph.edges[node.name])
    return LayerSchedule(
        name=node.name, op=node.kind, in_spatial=sp, out_spatial=sp,
        cin=cin, cout=cout, kernel=(), stride=(), plan=None, blocks=0,
        smem_bytes=0, macs=0, sparsity=0.0, dtype=_dtype_name(dtype))


def _layer_wb(entry, layer: _networks.UniformLayer):
    """Split one weight-tree entry into (w, bias-or-None, scale-or-None).

    Quantized entries (``repro_torch.quant.quantize_weights``' output)
    carry ``{"w_q": int8, "scale": per-cout}`` (plus ``"b"`` where the
    epilogue declares a bias) and are accepted wherever ``{"w", "b"}``
    is."""
    if isinstance(entry, dict):
        w = entry["w_q"] if "w_q" in entry else entry["w"]
        b, s = entry.get("b"), entry.get("scale")
    else:
        w, b, s = entry, None, None
    if layer.epilogue.bias and b is None:
        raise ScheduleError(f"layer {layer.name!r} declares a fused bias but "
                            f"its weight entry carries none (expected "
                            f"{{'w', 'b'}})")
    return w, b, s


def _run_layer(engine: UniformEngine, layer, entry, h: torch.Tensor):
    w, b, s = _layer_wb(entry, layer)
    kw = dict(device=h.device, dtype=h.dtype)
    # int8 weights stay int8 into the kernel (the cast that keeps a bf16
    # graph bf16 would dequantize them); the scale rides along as it is
    wv = w.to(**kw) if w.dtype.is_floating_point else w.to(h.device)
    return engine(layer, h, wv, None if b is None else b.to(**kw),
                  w_scale=None if s is None else s.to(h.device))


def _node_span(tel, graph, nd, ins) -> "_obs.Span":
    """The ``node`` span of one node of a walk (a layer, or a merge of a
    graph), named ``repro_torch.node.<node>`` in a profile."""
    if isinstance(nd, _networks.MergeNode):
        sp, cout = graph.node_shape(nd.name)
        fields = dict(op=nd.kind, in_spatial=sp, out_spatial=sp,
                      cin=sum(t.shape[-1] for t in ins), cout=cout)
    else:
        fields = dict(op=nd.op, in_spatial=nd.in_spatial,
                      out_spatial=nd.out_spatial, cin=nd.cin, cout=nd.cout)
    return tel.span("node", nd.name, dtype=_dtype_name(ins[0].dtype),
                    **fields)


def _graph_apply_fn(graph: _networks.UniformGraph, engine: UniformEngine):
    """The compiled DAG walk: one engine call per layer node (epilogue
    fused), one concat/add per merge node, intermediates dropped as soon
    as their last consumer has run; each node in its ``node`` span."""
    last_use: dict[str, str] = {}
    for name in graph.order:
        for p in graph.edges[name]:
            last_use[p] = name
    layer_names = [l.name for l in graph.layers]
    # the storage-dtype contract: with no preferred_element_type every node
    # emits its input's dtype, so a bf16 graph stays bf16 end to end
    keep_dtype = engine.config.preferred_element_type is None

    def apply(ws, x):
        missing = [n for n in layer_names if n not in ws]
        if missing:
            raise ScheduleError(f"graph weights missing entries for {missing}")
        tel = _obs.profiled(engine.config.telemetry)
        vals: dict[str, torch.Tensor] = {graph.INPUT: x.to(engine.device)}
        for name in graph.order:
            nd = graph.nodes[name]
            ins = [vals[p] for p in graph.edges[name]]
            with (_obs.NO_SPAN if tel is None
                  else _node_span(tel, graph, nd, ins)):
                if isinstance(nd, _networks.MergeNode):
                    if nd.kind == "concat":
                        vals[name] = torch.cat(ins, dim=-1)
                    else:
                        out = ins[0]
                        for v in ins[1:]:
                            out = out + v
                        vals[name] = out
                else:
                    h = ins[0]
                    out = _run_layer(engine, nd, ws[name], h)
                    vals[name] = out.to(h.dtype) if keep_dtype else out
            for p in graph.edges[name]:
                if last_use[p] == name and p != graph.output:
                    vals.pop(p, None)
        return vals[graph.output]

    return apply


# ---------------------------------------------------------------------------
# Mesh partitioning — batch over "data", optionally Cout/Cin over "model".
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _LayerPartition:
    """One layer's placement: its weight's partition spec (one mesh axis
    name or ``None`` per dim), the channel extents one rank holds, and the
    collective (if any) that follows the layer."""
    w_spec: tuple
    local_cin: int
    local_cout: int
    collective: str | None             # "psum" | "all_gather" | None


def _partition_layers(layers, policy: MeshPolicy,
                      model_size: int) -> list[_LayerPartition]:
    """Megatron-style alternation down the chain: shard a layer's Cout when
    it divides the model axis, contract the NEXT layer's (then-sharded) Cin
    and psum its partial outputs; a trailing channel-sharded output is
    all_gathered so the compiled callable always returns full channels."""
    parts = []
    act_sharded = False
    for i, l in enumerate(layers):
        cin_l, cout_l, coll = l.cin, l.cout, None
        spec = [None] * (l.rank + 2)
        if act_sharded:
            # input channels arrive sharded: each rank contracts its Cin
            # block into FULL-Cout partial sums, reduced right after
            spec[l.rank] = policy.model_axis
            cin_l = l.cin // model_size
            coll = "psum"
            act_sharded = False
        elif (model_size > 1 and l.cout % model_size == 0
              and l.cout // model_size >= policy.min_channel_block):
            spec[l.rank + 1] = policy.model_axis
            cout_l = l.cout // model_size
            act_sharded = True
            if i == len(layers) - 1:
                coll = "all_gather"
        parts.append(_LayerPartition(
            w_spec=tuple(spec), local_cin=cin_l,
            local_cout=cout_l, collective=coll))
    return parts


def _collective_bytes(layer, part: _LayerPartition, per_dev_batch: int,
                      act_bytes: int) -> int:
    """Per-rank payload entering the layer's collective: the tensor the
    rank hands ``all_reduce`` or ``all_gather``."""
    if part.collective is None:
        return 0
    chans = (layer.cout if part.collective == "psum" else part.local_cout)
    return act_bytes * per_dev_batch * math.prod(layer.out_spatial) * chans


def _mesh_extents(cfg: EngineConfig, batch: int) -> tuple[int, int]:
    """The data- and model-axis extents; a compile batch the data axis does
    not divide raises."""
    mesh, policy = cfg.mesh, cfg.policy
    dp = mesh.shape[policy.batch_axis]
    mp = mesh.shape[policy.model_axis] if policy.model_axis else 1
    if batch % dp:
        raise ScheduleError(
            f"compile batch {batch} does not divide the {dp}-way "
            f"{policy.batch_axis!r} mesh axis")
    return dp, mp


def shard_batch(batch, mesh, axis: str = "data"):
    """This rank's block of a global batch (a tensor, an array or a tree of
    them) along ``axis``: the slice of the leading dim a sharded
    ``compile_network`` callable or a data-parallel step takes."""
    n, i = mesh.shape[axis], mesh.coords[axis]

    def cut(x):
        if x.shape[0] % n:
            raise ScheduleError(f"batch {x.shape[0]} does not divide the "
                                f"{n}-way {axis!r} mesh axis")
        per = x.shape[0] // n
        return x[i * per:(i + 1) * per]

    return _tree.tree_map(cut, batch)


def _local_weight(w: torch.Tensor, spec: tuple, index: int,
                  size: int) -> torch.Tensor:
    """This rank's block of a full weight under its partition spec."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            n = w.shape[dim] // size
            w = w.narrow(dim, index * n, n)
    return w


def _compile_sharded(layers, engine: UniformEngine, batch: int,
                     dtype: torch.dtype):
    """A chain partitioned over the engine's mesh: each rank runs its batch
    shard through its channel shard of every layer, with the partition's
    all-reduces and all-gathers between, and the per-rank report."""
    cfg = engine.config
    mesh, policy = cfg.mesh, cfg.policy
    dp, mp = _mesh_extents(cfg, batch)
    parts = _partition_layers(layers, policy, mp)
    per_dev_batch = batch // dp
    # activation bytes entering the collectives: the storage dtype, else
    # the activations' own
    act_bytes = (cfg.preferred_element_type or dtype).itemsize
    report = ScheduleReport(
        engine=cfg, batch=batch, data_parallel=dp, model_parallel=mp,
        layers=tuple(
            _schedule_layer(l, engine, per_dev_batch, dtype,
                            local_cin=pt.local_cin, local_cout=pt.local_cout,
                            collective=pt.collective,
                            collective_bytes=_collective_bytes(
                                l, pt, per_dev_batch, act_bytes))
            for l, pt in zip(layers, parts)))
    m_index = mesh.coords[policy.model_axis] if policy.model_axis else 0

    def apply(ws, x):
        if len(ws) != len(layers):
            raise ScheduleError(f"expected {len(layers)} weight arrays, got "
                                f"{len(ws)}")
        if any(isinstance(e, dict) for e in ws):
            raise ScheduleError(
                "channel-partitioned chains take bare weight arrays; "
                "quantized {'w_q', 'scale'} entries are only supported on "
                "unsharded chains and (data-parallel) graph schedules")
        h = x.to(engine.device)
        for layer, w, part in zip(layers, ws, parts):
            w = _local_weight(w, part.w_spec, m_index, mp).to(
                device=h.device, dtype=h.dtype)
            epi = layer.epilogue
            if part.collective == "psum" and not epi.is_identity:
                # a channel-contracting layer produces PARTIAL sums: its
                # epilogue does not commute with the reduction, so it runs
                # after the all-reduce, outside the kernel
                op = engine.deconv if layer.op == "deconv" else engine.conv
                h = op(h, w, layer.stride, layer.padding,
                       dilation=layer.dilation, groups=layer.groups)
                h = _mesh.all_reduce(h, mesh.group(policy.model_axis))
                h = _kcommon.apply_epilogue(h, None, epi.activation,
                                            epi.alpha)
                continue
            h = engine(layer, h, w)
            if part.collective == "psum":
                h = _mesh.all_reduce(h, mesh.group(policy.model_axis))
            elif part.collective == "all_gather":
                h = _mesh.all_gather(h, mesh.group(policy.model_axis),
                                     dim=h.dim() - 1)
        return h

    return apply, report


def _graph_rows(graph: _networks.UniformGraph, engine: UniformEngine,
                batch: int, dtype: torch.dtype):
    return tuple(_schedule_layer(nd, engine, batch, dtype)
                 if isinstance(nd, _networks.UniformLayer)
                 else _schedule_merge(nd, graph, dtype)
                 for nd in (graph.nodes[n] for n in graph.order))


def _compile_graph_sharded(graph: _networks.UniformGraph,
                           engine: UniformEngine, batch: int,
                           dtype: torch.dtype):
    """A graph over the mesh's data axis alone: each rank walks the whole
    DAG on its batch shard with the weights replicated (skip tensors never
    cross ranks).  The rows carry one rank's accounting, the report's
    ``batch`` stays global, as on the chain path."""
    dp, _ = _mesh_extents(engine.config, batch)
    report = ScheduleReport(
        engine=engine.config, batch=batch, data_parallel=dp,
        layers=_graph_rows(graph, engine, batch // dp, dtype))
    return _graph_apply_fn(graph, engine), report


def compile_network(layers: Sequence[_networks.UniformLayer]
                    | _networks.UniformGraph,
                    engine: UniformEngine | EngineConfig | str,
                    *, batch: int = 1, dtype: torch.dtype = torch.float32,
                    ) -> tuple[Callable, ScheduleReport]:
    """Compile a ``UniformLayer`` chain OR a ``UniformGraph`` DAG onto one
    configured engine.

    Returns ``(apply, report)``: ``apply(ws, x)`` runs every node on the
    engine in schedule order (``x`` moves to the engine's device; weights
    should already live there), and ``report`` is the per-node
    ``ScheduleReport`` for a batch-``batch`` forward in ``dtype`` — every
    plan it lists is resident in the engine's cache, so ``apply`` never
    re-runs the planner.

    For a chain, ``ws`` is the per-layer weight list (each
    ``[*K, Cin/groups, Cout]``, or ``{"w", "b"}``).  For a graph, ``ws`` is
    a dict keyed by layer name (``init_network_weights`` builds it).
    Either takes quantized ``{"w_q", "scale"}`` entries
    (``repro_torch.quant.quantize_weights``); ``report``'s ``precision``
    column shows each layer's resolved policy.
    Merge nodes own no weights; on ``"pallas"`` epilogues run inside the
    kernels, on a reference lowering on each op's output.

    With a mesh-aware engine (``EngineConfig(mesh=..., policy=...)``)
    ``apply`` runs on every rank of the mesh: it takes the rank's shard of
    the batch (``shard_batch``) and the FULL weights, and returns the
    rank's shard of the output.  A chain partitions per the policy's model
    axis (bare weight tensors only); a graph over the batch axis alone,
    weights replicated, since its skip merges would otherwise gather at
    every node.  The report's rows are then per rank, at the per-rank
    batch.

    Its ``compile`` span (and ``engine_compiles_total``) and the
    ``apply`` span of each call (``obs.instrument_apply``) go to
    ``obs.active``: the engine's telemetry, which also times each call's
    host dispatch into ``engine_dispatch_seconds`` and counts it, else a
    profile's recorder.  A ``node`` span per node of an unsharded walk goes
    to ``obs.profiled``, only while a profiler records.
    """
    engine = engine if isinstance(engine, UniformEngine) else as_engine(engine)
    tel = _obs.active(engine.config.telemetry)
    if tel is None:
        apply, report, tag = _compile(layers, engine, batch, dtype)
    else:
        with tel.span("compile", batch=batch) as span:
            apply, report, tag = _compile(layers, engine, batch, dtype)
            span.set(schedule=tag, nodes=len(report.layers))
        tel.counter("engine_compiles_total", schedule=tag).inc()
    return _obs.instrument_apply(apply, engine.config.telemetry,
                                 tag), report


def _compile(layers, engine: UniformEngine, batch: int, dtype: torch.dtype):
    """``compile_network``'s work: ``(apply, report, schedule tag)``."""
    if isinstance(layers, _networks.UniformGraph):
        graph = layers
        tag = f"graph:{graph.output}"
        if engine.config.mesh is not None:
            apply, report = _compile_graph_sharded(graph, engine, batch,
                                                   dtype)
        else:
            report = ScheduleReport(engine=engine.config, batch=batch,
                                    layers=_graph_rows(graph, engine, batch,
                                                       dtype))
            apply = _graph_apply_fn(graph, engine)
        return apply, report, tag
    chain = tuple(layers)
    if not chain:
        raise ScheduleError("compile_network needs at least one layer")
    for prev, nxt in zip(chain, chain[1:]):
        if prev.out_spatial != nxt.in_spatial or prev.cout != nxt.cin:
            raise ScheduleError(
                f"layer chain breaks at {prev.name} -> {nxt.name}: "
                f"{prev.out_spatial}x{prev.cout} != "
                f"{nxt.in_spatial}x{nxt.cin}")
    tag = f"chain:{chain[0].name}x{len(chain)}"
    if engine.config.mesh is not None:
        apply, report = _compile_sharded(chain, engine, batch, dtype)
        return apply, report, tag
    report = ScheduleReport(
        engine=engine.config, batch=batch,
        layers=tuple(_schedule_layer(l, engine, batch, dtype)
                     for l in chain))

    def apply(ws, x):
        if len(ws) != len(chain):
            raise ScheduleError(f"expected {len(chain)} weight "
                                f"entries, got {len(ws)}")
        tel = _obs.profiled(engine.config.telemetry)
        h = x.to(engine.device)
        for layer, entry in zip(chain, ws):
            with (_obs.NO_SPAN if tel is None
                  else _node_span(tel, None, layer, [h])):
                h = _run_layer(engine, layer, entry, h)
        return h

    return apply, report, tag


def init_network_weights(layers: Sequence[_networks.UniformLayer]
                         | _networks.UniformGraph,
                         generator: torch.Generator,
                         dtype: torch.dtype = torch.float32,
                         scale: float = 0.05):
    """Random weights for a compiled network, on the CPU, drawn from
    ``generator``: a per-layer ``[*K, Cin/G, Cout]`` list for a chain, or
    the name-keyed dict ``compile_network`` expects for a graph (``{"w",
    "b"}`` entries where the epilogue declares a bias, zero biases)."""
    def draw(l):
        return scale * torch.randn(l.weight_shape, generator=generator,
                                   dtype=dtype)

    if isinstance(layers, _networks.UniformGraph):
        ws = {}
        for l in layers.layers:
            w = draw(l)
            ws[l.name] = ({"w": w, "b": torch.zeros(l.cout, dtype=dtype)}
                          if l.epilogue.bias else w)
        return ws
    return [draw(l) for l in layers]
