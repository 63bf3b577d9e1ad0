"""Engine-backed DCNN inference server on the hand-written Hopper kernels:
deadlines, degradation, recovery.

DCGAN generation and V-Net segmentation requests are served from compiled
``UniformGraph`` schedules, eagerly (no graph capture yet), on a primary
engine (the hand kernels) with a fallback engine (the cuDNN lowering,
``"xla"``) beside it.  Every failure mode is survivable and visible:

  * **bounded queue + load shedding** — ``submit`` raises a typed
    ``QueueFullError`` at capacity;
  * **per-request deadlines** — expired requests complete with a typed
    ``DeadlineExceededError`` (never silently dropped);
  * **shape-bucketed schedule cache** — requests bucket by (model, padded
    spatial, padded batch); each bucket compiles once via
    ``compile_network`` and lives in an LRU (``max_schedules``);
  * **retry with exponential backoff** — a dispatch that raises retries
    on a deterministic ``Backoff`` schedule;
  * **graceful degradation** — a bucket whose schedule fails to compile
    (``ScheduleError``/``VmemBudgetError``/injected compile fault) or to
    dispatch (after retries) on the primary degrades to the fallback
    engine, records it, and probes the primary every ``probe_every``
    batches to recover; when both fail its requests complete with a typed
    ``DispatchFailedError``;
  * **NaN/Inf output guard** — poisoned rows are quarantined with a typed
    ``PoisonedOutputError`` and the rest of the batch re-runs;
  * **stats/health surface** — queue depth, shed/expired counts, per-bucket
    engine state and latency percentiles, schedule-cache hit/miss/eviction
    counters.

Fault injection plugs in as a ``repro_torch.runtime.faults.FaultScript``:
every compile runs through its ``compile`` channel and every compiled
schedule is wrapped on its ``dispatch`` channel, under the JAX package's
tags, so one script drives the same failures in both servers.

A quantized model is a ``ModelSpec`` whose weights came from
``repro_torch.quant.quantize_weights``, served on an engine configured with
the matching ``EngineConfig(precision=...)``, as in the JAX package; the
self-built fallback ignores that policy, as the reference's does.
Weights move to each engine's device once per model, dtypes kept (int8
weights stay int8).
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Any, Callable, Mapping

import numpy as np
import torch

from repro_torch import obs as _obs
from repro_torch.convert import check_weights
from repro_torch.core import networks as _networks
from repro_torch.core.engine import (
    EngineConfig,
    ScheduleError,
    UniformEngine,
    compile_network,
    init_network_weights,
)
from repro_torch.runtime import faults as _faults
from repro_torch.runtime.serving import (
    Backoff,
    DeadlineExceededError,
    DispatchFailedError,
    InvalidRequestError,
    PoisonedOutputError,
    RequestQueue,
    ServeError,
    latency_summary,
)


# ---------------------------------------------------------------------------
# Model specs — what the server serves.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ModelSpec:
    """One served model: a graph family plus its weights.

    ``graph_for(padded_spatial)`` builds the ``UniformGraph`` for a padded
    sample geometry (``None``: the native geometry); weights are
    name-compatible across buckets.  ``spatial_multiple`` is the per-dim
    bucket granularity requests pad up to (None = the geometry is fixed).
    ``weights`` is the name-keyed tree of tensors, checked against the
    native graph.
    """
    name: str
    graph_for: Callable[[tuple[int, ...] | None], _networks.UniformGraph]
    weights: Mapping[str, Any]
    spatial_multiple: tuple[int, ...] | int | None = None

    def __post_init__(self):
        base = self.graph_for(None)          # the native geometry
        check_weights(base, self.weights)
        self.base_spatial, self.cin = base.in_shape
        self.rank = len(self.base_spatial)
        if isinstance(self.spatial_multiple, int):
            self.spatial_multiple = (self.spatial_multiple,) * self.rank

    def bucket_spatial(self, sp: tuple[int, ...]) -> tuple[int, ...]:
        """Round a sample's spatial extent up to its padding bucket."""
        if self.spatial_multiple is None:
            return self.base_spatial
        return tuple(max(b, -(-v // m) * m)
                     for v, m, b in zip(sp, self.spatial_multiple,
                                        self.base_spatial))

    def validate(self, x: np.ndarray) -> tuple[int, ...]:
        """Typed validation of one sample; returns its spatial extent."""
        if x.ndim != self.rank + 1:
            raise InvalidRequestError(
                f"model {self.name!r} expects [*spatial({self.rank}d), "
                f"cin={self.cin}] samples, got shape {tuple(x.shape)}")
        if x.shape[-1] != self.cin:
            raise InvalidRequestError(
                f"model {self.name!r} expects cin={self.cin}, got "
                f"{x.shape[-1]} (shape {tuple(x.shape)})")
        sp = tuple(x.shape[:-1])
        if self.spatial_multiple is None and sp != self.base_spatial:
            raise InvalidRequestError(
                f"model {self.name!r} serves the fixed geometry "
                f"{self.base_spatial}, got {sp}")
        if self.spatial_multiple is not None and \
                any(v > b * 8 for v, b in zip(sp, self.base_spatial)):
            raise InvalidRequestError(
                f"model {self.name!r}: spatial {sp} exceeds the serving "
                f"ceiling {tuple(8 * b for b in self.base_spatial)}")
        return sp


def _generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def dcgan_gen_spec(generator: torch.Generator | None = None, *,
                   weights=None, start: int = 4, chans=(32, 16, 8, 4, 3),
                   name: str = "dcgan_gen") -> ModelSpec:
    """A DCGAN generator (fixed seed-grid geometry, fused bias+relu and a
    final bias+tanh) as a served model.  ``chans=(1024, 512, 256, 128, 3)``
    is the paper's full width.  ``weights`` (e.g. from
    ``convert.weights_from_numpy``) replaces the seeded random init."""
    layers = _networks.deconv_stack(name, 2, start, list(chans))
    layers = [dataclasses.replace(l, epilogue=_networks.Epilogue(
                  bias=True,
                  activation="tanh" if i == len(layers) - 1 else "relu"))
              for i, l in enumerate(layers)]
    graph = _networks.chain_graph(layers)
    if weights is None:
        weights = init_network_weights(graph, generator or _generator(0))
    return ModelSpec(name=name, graph_for=lambda sp: graph, weights=weights,
                     spatial_multiple=None)


def vnet_spec(generator: torch.Generator | None = None, *, weights=None,
              chans=(2, 4, 8), cin: int = 1, num_classes: int = 2,
              base_spatial=(8, 8, 8), name: str = "vnet") -> ModelSpec:
    """A V-Net (variable volume geometry) as a served model: volumes pad up
    to multiples of ``2**(stages-1)`` per dim and bucket there.
    ``chans=(16, 32, 64, 128, 256)`` at ``base_spatial=(128, 128, 64)`` is
    the paper's full size."""
    mult = 2 ** (len(chans) - 1)

    def graph_for(sp):
        return _networks.vnet_graph(
            in_spatial=tuple(sp) if sp is not None else tuple(base_spatial),
            chans=tuple(chans), cin=cin, num_classes=num_classes, name=name)

    if weights is None:
        weights = init_network_weights(graph_for(None),
                                       generator or _generator(1))
    return ModelSpec(name=name, graph_for=graph_for, weights=weights,
                     spatial_multiple=mult)


# ---------------------------------------------------------------------------
# Requests and results.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServeRequest:
    """One inference request: a single sample for one served model."""
    model: str
    x: np.ndarray                       # [*spatial, cin]
    deadline_s: float | None = None     # relative to submit time
    id: int = -1                        # assigned by the server
    # internal routing, filled at submit:
    _spatial: tuple[int, ...] = ()
    _bucket_sp: tuple[int, ...] = ()


@dataclasses.dataclass
class ServeResult:
    """One completed (or typed-failed) request."""
    id: int
    model: str
    ok: bool
    output: np.ndarray | None
    error: ServeError | None
    engine: str | None                  # method that served it
    latency_s: float
    bucket: str

    @property
    def code(self) -> str:
        return "ok" if self.ok else self.error.code


@dataclasses.dataclass
class _BucketState:
    """Per-bucket degradation state; ``latencies`` is the bucket's registry
    histogram."""
    method: str
    primary: str
    latencies: _obs.Histogram
    batches: int = 0
    since_fallback: int = 0
    fallback_reason: str | None = None
    fallbacks: int = 0
    recoveries: int = 0
    probes_failed: int = 0

    @property
    def degraded(self) -> bool:
        return self.method != self.primary


class _RegistryCounters:
    """Dict-shaped view over registry ``Counter``s (``counters["x"] += 1``
    lands on the shared instrument)."""

    def __init__(self, registry: _obs.MetricsRegistry, names,
                 prefix: str = "serve_"):
        self._c = {n: registry.counter(f"{prefix}{n}_total") for n in names}

    def keys(self):
        return self._c.keys()

    def __getitem__(self, k) -> int:
        return int(self._c[k].value)

    def __setitem__(self, k, v) -> None:
        self._c[k].inc(v - int(self._c[k].value))   # += lands here as set


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def pad_to(x: np.ndarray, spatial: tuple[int, ...]) -> np.ndarray:
    """Zero-pad a sample's spatial dims (trailing) up to ``spatial``."""
    pads = [(0, t - s) for s, t in zip(x.shape[:-1], spatial)] + [(0, 0)]
    if all(lo == 0 and hi == 0 for lo, hi in pads):
        return x
    return np.pad(x, pads)


def _to_numpy(y: torch.Tensor) -> np.ndarray:
    if y.dtype == torch.bfloat16:       # numpy has no bfloat16
        y = y.to(torch.float32)
    return y.cpu().numpy()


class DcnnServer:
    """The DCNN inference server on the uniform engine.

        server = DcnnServer([dcgan_gen_spec(), vnet_spec()])
        rid = server.submit(ServeRequest("vnet", vol, deadline_s=1.0))
        results = server.drain()          # or step() per batch
        print(server.stats())

    ``primary``/``fallback`` name the two engine methods.  ``engines``
    maps each name to its engine; without it the primary is ``engine``
    or, by default, a strict-budget hand-kernel engine on ``device``, and
    the fallback an engine of method ``fallback`` with the default
    precision and the server's telemetry on the primary's device.
    ``faults`` plugs a ``FaultScript`` into every compile and dispatch.
    ``clock``/``Backoff.sleep`` are injectable for deterministic tests.
    """

    def __init__(self, specs, *, primary: str = "pallas",
                 fallback: str = "xla", engine: UniformEngine | None = None,
                 engines: Mapping[str, UniformEngine] | None = None,
                 device="cuda", max_queue: int = 64, max_batch: int = 8,
                 max_schedules: int = 8, probe_every: int = 4,
                 backoff: Backoff | None = None,
                 max_tile_bytes: int | None = None,
                 faults: _faults.FaultScript | None = None,
                 telemetry: _obs.Telemetry | None = None,
                 clock: Callable[[], float] = time.monotonic):
        specs = [specs] if isinstance(specs, ModelSpec) else list(specs)
        self.specs: dict[str, ModelSpec] = {s.name: s for s in specs}
        self.telemetry = (telemetry if telemetry is not None
                          else _obs.Telemetry.create())
        if engines is None:
            if engine is None:
                engine = UniformEngine(EngineConfig(
                    method=primary, strict_vmem=True,
                    max_tile_bytes=max_tile_bytes, telemetry=self.telemetry,
                    device=device))
            engines = {primary: engine, fallback: UniformEngine(EngineConfig(
                method=fallback, telemetry=self.telemetry,
                device=engine.device))}
        elif engine is not None:
            raise ValueError("pass engine= (the primary) or engines=, not "
                             "both")
        self.engines = dict(engines)
        for m in (primary, fallback):
            if m not in self.engines:
                raise ValueError(f"no engine configured for method {m!r}")
        self.primary = primary
        self.fallback = fallback
        self.engine = self.engines[primary]
        self.max_batch = max_batch
        self.probe_every = probe_every
        self.backoff = backoff or Backoff()
        self.faults = faults
        self.clock = clock
        self.queue = RequestQueue(max_queue, clock)
        self.max_schedules = max_schedules
        self._schedules: OrderedDict[tuple, Callable] = OrderedDict()
        self._device_weights: dict[tuple, Any] = {}
        self._buckets: dict[tuple, _BucketState] = {}
        self._next_id = 0
        self.counters = _RegistryCounters(self.telemetry.registry, (
            "completed", "rejected", "retries", "quarantined", "reruns",
            "fallbacks", "recoveries", "probes_failed", "cache_hits",
            "cache_misses", "cache_evictions", "dispatch_failures",
        ))
        self._queue_wait = self.telemetry.histogram(
            "serve_queue_wait_seconds")

    # -- admission -----------------------------------------------------------

    def submit(self, req: ServeRequest) -> int:
        """Validate + enqueue one request; returns its id.  Raises
        ``InvalidRequestError`` (bad model/shape) or ``QueueFullError``
        (shed) — typed, never a crash later."""
        spec = self.specs.get(req.model)
        if spec is None:
            self.counters["rejected"] += 1
            raise InvalidRequestError(
                f"unknown model {req.model!r}; serving "
                f"{sorted(self.specs)}")
        x = np.asarray(req.x)
        try:
            sp = spec.validate(x)
        except InvalidRequestError:
            self.counters["rejected"] += 1
            raise
        req.x = x
        req.id = self._next_id
        req._spatial = sp
        req._bucket_sp = spec.bucket_spatial(sp)
        self.queue.submit(req, deadline_s=req.deadline_s)   # may shed
        self._next_id += 1
        return req.id

    # -- the schedule cache --------------------------------------------------

    def _weights(self, model: str, method: str | None = None):
        """The model's weights on ``method``'s engine's device (the
        primary's by default), moved once per device."""
        dev = self.engines[method or self.primary].device
        ws = self._device_weights.get((model, dev))
        if ws is None:
            def move(node):
                if isinstance(node, dict):
                    return {k: move(v) for k, v in node.items()}
                return node.to(dev)

            ws = self._device_weights[(model, dev)] = move(
                dict(self.specs[model].weights))
        return ws

    def _schedule(self, model: str, bucket_sp: tuple[int, ...],
                  batch: int, method: str) -> Callable:
        """Compile (or fetch) the bucket's schedule on ``method``; LRU over
        (model, spatial, batch, method).  Compile faults and schedule
        errors (a budget overflow included) propagate to the caller's
        degradation logic."""
        key = (model, bucket_sp, batch, method)
        fn = self._schedules.get(key)
        if fn is not None:
            self._schedules.move_to_end(key)
            self.counters["cache_hits"] += 1
            return fn
        self.counters["cache_misses"] += 1
        tag = f"{method}:{model}:{'x'.join(map(str, bucket_sp))}b{batch}"
        if self.faults is not None:
            self.faults.on_call("compile", tag)   # may raise injected
        graph = self.specs[model].graph_for(bucket_sp)
        fn, _report = compile_network(graph, self.engines[method],
                                      batch=batch)
        if self.faults is not None:
            fn = self.faults.wrap_schedule(fn, tag)
        self._schedules[key] = fn
        while len(self._schedules) > self.max_schedules:
            self._schedules.popitem(last=False)
            self.counters["cache_evictions"] += 1
        return fn

    # -- dispatch ------------------------------------------------------------

    def _dispatch(self, model: str, bucket_sp: tuple[int, ...],
                  method: str, xb: np.ndarray) -> np.ndarray:
        """One batch on one engine, retried with backoff when it raises.
        Raises ``ScheduleError``/``InjectedCompileError`` (compile-shaped,
        no retry) or ``DispatchFailedError`` (retries exhausted)."""
        fn = self._schedule(model, bucket_sp, xb.shape[0], method)
        ws = self._weights(model, method)
        x = torch.from_numpy(xb)
        attempt = 0
        with self.telemetry.span("dispatch", model=model, method=method,
                                 batch=xb.shape[0]) as sp:
            while True:
                try:
                    with torch.inference_mode():
                        y = _to_numpy(fn(ws, x))
                    sp.set(attempts=attempt)
                    return y
                except (ScheduleError, _faults.InjectedCompileError):
                    raise                  # compile-shaped: never retried
                except Exception as e:     # noqa: BLE001 — retry, then type
                    if attempt >= self.backoff.max_retries:
                        raise DispatchFailedError(
                            f"{method} dispatch failed after {attempt} "
                            f"retries: {e!r}") from e
                    self.counters["retries"] += 1
                    self.backoff.wait(attempt)
                    attempt += 1

    def _run_on(self, model: str, bucket_sp, method: str,
                xb: np.ndarray) -> np.ndarray:
        """Dispatch on ``method``'s engine: the batch's raw host output."""
        return self._dispatch(model, bucket_sp, method, xb)

    # -- serving -------------------------------------------------------------

    def _expire(self, tickets) -> list[ServeResult]:
        now = self.clock()
        return [ServeResult(
            id=t.item.id, model=t.item.model, ok=False, output=None,
            error=DeadlineExceededError(
                f"request {t.item.id} expired after "
                f"{now - t.submitted:.3f}s in queue"),
            engine=None, latency_s=now - t.submitted,
            bucket=self._bucket_name(t.item)) for t in tickets]

    @staticmethod
    def _bucket_name(req: ServeRequest) -> str:
        return f"{req.model}/{'x'.join(map(str, req._bucket_sp))}"

    def step(self) -> list[ServeResult]:
        """Serve one batch: sweep deadlines, assemble the head bucket's
        batch (padded to its batch bucket), run it, and return every
        completed/typed-failed result."""
        results = self._expire(self.queue.sweep_expired())
        head = self.queue.peek()
        if head is None:
            return results
        model, bsp = head.item.model, head.item._bucket_sp
        tickets = self.queue.take(
            self.max_batch,
            pred=lambda r: r.model == model and r._bucket_sp == bsp)
        if tickets:
            now = self.clock()
            for t in tickets:
                self._queue_wait.observe(now - t.submitted)
            results.extend(self._serve_batch(model, bsp, tickets))
        return results

    def drain(self, max_steps: int = 1000) -> list[ServeResult]:
        """Step until the queue is empty; returns every result."""
        out: list[ServeResult] = []
        for _ in range(max_steps):
            if self.queue.depth == 0:
                out.extend(self.step())   # final deadline sweep
                break
            out.extend(self.step())
        return out

    def _fail_all(self, model, tickets, err: ServeError) -> list[ServeResult]:
        self.counters["dispatch_failures"] += 1
        now = self.clock()
        return [ServeResult(
            id=t.item.id, model=model, ok=False, output=None, error=err,
            engine=None, latency_s=now - t.submitted,
            bucket=self._bucket_name(t.item)) for t in tickets]

    def _poisoned(self, model, t, msg: str, now: float,
                  served_by: str) -> ServeResult:
        return ServeResult(
            id=t.item.id, model=model, ok=False, output=None,
            error=PoisonedOutputError(msg), engine=served_by,
            latency_s=now - t.submitted, bucket=self._bucket_name(t.item))

    # the batch pipeline: degradation -> dispatch -> NaN guard -> slice

    def _serve_batch(self, model, bsp, tickets,
                     rerun_depth: int = 0) -> list[ServeResult]:
        batch = min(_next_pow2(len(tickets)), self.max_batch)
        bkey = (model, bsp, batch)
        state = self._buckets.get(bkey)
        if state is None:
            label = f"{model}/{'x'.join(map(str, bsp))}/b{batch}"
            state = self._buckets[bkey] = _BucketState(
                method=self.primary, primary=self.primary,
                latencies=self.telemetry.histogram(
                    "serve_latency_seconds", bucket=label))

        xb = np.zeros((batch, *bsp, self.specs[model].cin),
                      np.asarray(tickets[0].item.x).dtype)
        for i, t in enumerate(tickets):
            xb[i] = pad_to(np.asarray(t.item.x), bsp)

        y, served_by, fail = None, None, None
        if state.degraded and state.since_fallback >= self.probe_every:
            # recovery probe: one batch on the primary
            try:
                y = self._run_on(model, bsp, self.primary, xb)
                state.method = self.primary
                state.since_fallback = 0
                state.fallback_reason = None
                state.recoveries += 1
                self.counters["recoveries"] += 1
                self.telemetry.event(
                    "recovery", model=model,
                    bucket=self._bucket_name(tickets[0].item))
                served_by = self.primary
            except Exception:             # noqa: BLE001
                state.probes_failed += 1
                state.since_fallback = 0
                self.counters["probes_failed"] += 1
        if y is None:
            try:
                y = self._run_on(model, bsp, state.method, xb)
                served_by = state.method
            except Exception as e:        # noqa: BLE001
                fail = e
        if y is None and fail is not None and not state.degraded:
            # degrade THIS bucket to the fallback engine and record it
            state.method = self.fallback
            state.fallback_reason = repr(fail)
            state.since_fallback = 0
            state.fallbacks += 1
            self.counters["fallbacks"] += 1
            self.telemetry.event("fallback", model=model,
                                 bucket=self._bucket_name(tickets[0].item),
                                 reason=repr(fail))
            try:
                y = self._run_on(model, bsp, self.fallback, xb)
                served_by = self.fallback
                fail = None
            except Exception as e:        # noqa: BLE001
                fail = e
        if y is None:
            # every engine failed: typed completion, never a crash
            return self._fail_all(model, tickets, (
                fail if isinstance(fail, ServeError)
                else DispatchFailedError(f"all engines failed: {fail!r}")))

        state.batches += 1
        if state.degraded:
            state.since_fallback += 1

        # NaN/Inf output guard: quarantine poisoned rows, re-run the rest
        bad = set(_faults.poisoned_rows(y[:len(tickets)]))
        results: list[ServeResult] = []
        now = self.clock()
        if bad:
            clean = [t for i, t in enumerate(tickets) if i not in bad]
            for i in sorted(bad):
                t = tickets[i]
                self.counters["quarantined"] += 1
                results.append(self._poisoned(
                    model, t, f"request {t.item.id}: non-finite output "
                    f"quarantined", now, served_by))
            if clean and rerun_depth >= 2:
                # still poisoned after two re-runs: the clean rows give up
                # too, typed, as the reference's do
                for t in clean:
                    self.counters["quarantined"] += 1
                    results.append(self._poisoned(
                        model, t, "batch poisoned on every re-run", now,
                        served_by))
            elif clean:
                self.counters["reruns"] += 1
                results.extend(self._serve_batch(model, bsp, clean,
                                                 rerun_depth + 1))
            return results

        # slice each request's rows + crop its spatial padding
        graph_out_sp, _ = self.specs[model].graph_for(bsp).out_shape
        for i, t in enumerate(tickets):
            r = t.item
            crop = tuple(o * v // p for v, p, o in
                         zip(r._spatial, bsp, graph_out_sp))
            sl = (i,) + tuple(slice(0, c) for c in crop)
            lat = now - t.submitted
            state.latencies.observe(lat)
            self.counters["completed"] += 1
            results.append(ServeResult(
                id=r.id, model=model, ok=True, output=y[sl],
                error=None, engine=served_by, latency_s=lat,
                bucket=self._bucket_name(r)))
        return results

    # -- the health/stats surface --------------------------------------------

    def stats(self) -> dict:
        buckets = {
            f"{model}/{'x'.join(map(str, bsp))}/b{batch}": {
                "engine": st.method,
                "degraded": st.degraded,
                "fallback_reason": st.fallback_reason,
                "batches": st.batches,
                "fallbacks": st.fallbacks,
                "recoveries": st.recoveries,
                "probes_failed": st.probes_failed,
                **latency_summary(st.latencies)}
            for (model, bsp, batch), st in self._buckets.items()}
        self.telemetry.gauge("serve_queue_depth").set(self.queue.depth)
        self.telemetry.gauge("serve_submitted").set(self.queue.submitted)
        self.telemetry.gauge("serve_shed").set(self.queue.shed)
        self.telemetry.gauge("serve_expired").set(self.queue.expired)
        return {
            "queue_depth": self.queue.depth,
            "submitted": self.queue.submitted,
            "shed": self.queue.shed,
            "expired": self.queue.expired,
            **{k: self.counters[k] for k in self.counters.keys()},
            "schedule_cache": {
                "size": len(self._schedules),
                "capacity": self.max_schedules,
                "hits": self.counters["cache_hits"],
                "misses": self.counters["cache_misses"],
                "evictions": self.counters["cache_evictions"],
            },
            "buckets": buckets,
        }

    def health(self) -> dict:
        """The load-balancer view: alive, degraded-bucket list, depth."""
        degraded = [k for k, b in self.stats()["buckets"].items()
                    if b["degraded"]]
        return {
            "ok": True,                    # a crash would have raised typed
            "queue_depth": self.queue.depth,
            "shed": self.queue.shed,
            "degraded_buckets": degraded,
            "fully_primary": not degraded,
            "dispatch_failures": self.counters["dispatch_failures"],
        }
