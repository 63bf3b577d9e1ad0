"""Runtime utilization reports: the paper's Fig. 6 table from live runs.

``ScheduleReport`` is static: the tile plans, blocks and shared memory
decided at compile time.  ``RuntimeReport`` closes the loop:
``measure_network`` runs every node of a compiled chain or DAG on its
own, joins the measured time against the schedule rows and the layers'
valid MACs, and normalises by a machine roof to report achieved GFLOP/s
and utilization per layer — the measured counterpart of the paper's
utilization claim, and what the autotuner (``repro_torch.tune``) times
its candidates with.  On the card a node's time is the device's, with
the host's time to issue the node beside it (``_time_call``): a layer's
wrapper takes 0.05-0.2 ms of host time, as long as many small layers'
kernels, and would otherwise swamp the differences between their plans.

The roof comes from ``machine_peak_gflops()``: the ``REPRO_PEAK_GFLOPS``
environment variable when set, else a cached one-shot f32 matmul probe on
the device asked for.  On the card the probe runs under
``functional.ieee_f32()``, so it measures the CUDA cores' IEEE f32 rate,
the rate the f32 kernels (the ``"fma"`` route) run at; on the CPU it runs
on the host.  ``machine_mem_gbps()`` is the bandwidth roof the same way
(``REPRO_MEM_GBPS``, else a copy of a buffer far larger than the card's
L2).

Also here: ``instrument_apply``, the ``apply`` span ``compile_network``
wraps its callable in.  It passes straight through while a CUDA graph is
being captured, and otherwise, with the engine's telemetry, times the
host's dispatch of the call, without waiting for the device; it adds no
kernel launch.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Any, Callable

import torch

from repro_torch import tree

# ---------------------------------------------------------------------------
# The roofline peaks.
# ---------------------------------------------------------------------------

_PEAK_CACHE: dict = {}
# the probes' sizes: a matmul that fills an H100 and a buffer of 1 GiB
# (the card's L2 is 50 MB); the host's as the JAX package sizes them
_CARD_MATMUL_N = 8192
_CARD_COPY_ELEMS = 1 << 28
_HOST_MATMUL_N = 256
_HOST_COPY_ELEMS = 1 << 22


def _sleep_cycles_per_s(device: torch.device) -> float:
    """The rate of ``torch.cuda._sleep``'s cycles on ``device``, timed
    once with CUDA events and cached."""
    key = ("sleep", str(device))
    if key not in _PEAK_CACHE:
        cycles = 1 << 22
        stream = torch.cuda.current_stream(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)                 # warm
        start.record(stream)
        torch.cuda._sleep(cycles)
        end.record(stream)
        end.synchronize()
        _PEAK_CACHE[key] = cycles / (start.elapsed_time(end) / 1e3)
    return _PEAK_CACHE[key]


def _time_call(fn: Callable[[], Any], device: torch.device,
               repeats: int) -> tuple[float, float]:
    """``(device_s, host_s)``: best-of-``repeats`` seconds of ``fn()``
    after one warm call.

    On the card ``host_s`` is the host's time to issue the call (the
    device idle), and ``device_s`` the card's time for the call's work
    alone: CUDA events on the current stream around the call, behind a
    device-side sleep of twice the issue time (at least 0.5 ms), so that
    the whole call is queued before the first event fires and the host's
    issue time falls outside the events.  On the CPU both are the host
    clock around the call."""
    fn()
    if device.type != "cuda":
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return best, best
    torch.cuda.synchronize(device)
    host = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        host = min(host, time.perf_counter() - t0)
        torch.cuda.synchronize(device)
    cycles = int(max(2 * host, 5e-4) * _sleep_cycles_per_s(device))
    stream = torch.cuda.current_stream(device)
    best = float("inf")
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record(stream)
        fn()
        end.record(stream)
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best, host


def _probe_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available to probe; pass "
                           "device='cpu' or set the REPRO_* overrides")
    return device


def _calibrate_peak_gflops(device: torch.device, repeats: int = 5) -> float:
    """Best-of-``repeats`` IEEE f32 ``n x n`` matmul throughput, GFLOP/s."""
    from repro_torch.core.functional import ieee_f32

    n = _CARD_MATMUL_N if device.type == "cuda" else _HOST_MATMUL_N
    a = torch.ones((n, n), dtype=torch.float32, device=device)
    out = torch.empty_like(a)
    with ieee_f32():
        s, _ = _time_call(lambda: torch.matmul(a, a, out=out), device,
                          repeats)
    return 2.0 * n ** 3 / s / 1e9


def machine_peak_gflops(*, force: bool = False, device="cuda") -> float:
    """The dense f32 roof used to normalise utilization, in GFLOP/s.

    ``REPRO_PEAK_GFLOPS`` overrides (a data-sheet number); otherwise a
    matmul probe on ``device``, cached per device type (``force``
    re-measures).  A ``"cuda"`` probe with no card raises.
    """
    env = os.environ.get("REPRO_PEAK_GFLOPS")
    if env is not None:
        return float(env)
    device = _probe_device(device)
    key = ("peak", device.type)
    if force or key not in _PEAK_CACHE:
        _PEAK_CACHE[key] = _calibrate_peak_gflops(device)
    return _PEAK_CACHE[key]


def _calibrate_mem_gbps(device: torch.device, repeats: int = 5) -> float:
    """Best-of-``repeats`` streaming bandwidth in GB/s: one read and one
    write of an f32 buffer (on the card, far larger than L2)."""
    n = _CARD_COPY_ELEMS if device.type == "cuda" else _HOST_COPY_ELEMS
    a = torch.ones((n,), dtype=torch.float32, device=device)
    b = torch.empty_like(a)
    s, _ = _time_call(lambda: b.copy_(a), device, repeats)
    return 2.0 * a.numel() * a.element_size() / s / 1e9


def machine_mem_gbps(*, force: bool = False, device="cuda") -> float:
    """The streaming-bandwidth roof of the tuner's latency model, GB/s.

    ``REPRO_MEM_GBPS`` overrides (a data-sheet number); otherwise a copy
    probe on ``device``, cached per device type — the sloped roof of the
    roofline whose flat roof ``machine_peak_gflops`` measures.
    """
    env = os.environ.get("REPRO_MEM_GBPS")
    if env is not None:
        return float(env)
    device = _probe_device(device)
    key = ("mem", device.type)
    if force or key not in _PEAK_CACHE:
        _PEAK_CACHE[key] = _calibrate_mem_gbps(device)
    return _PEAK_CACHE[key]


# ---------------------------------------------------------------------------
# Host-side dispatch instrumentation.
# ---------------------------------------------------------------------------

def _capturing() -> bool:
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def instrument_apply(apply: Callable, telemetry, tag: str) -> Callable:
    """Wrap a compiled ``apply`` in its ``apply`` span.

    The span goes to ``obs.active(telemetry)``: ``telemetry`` (the
    engine's) when given, else a profile's recorder while one records;
    with neither, and while a CUDA graph is being captured, the wrapper is
    a pure pass-through.  With ``telemetry`` each call also records its
    host duration into the ``engine_dispatch_seconds`` histogram and one
    into the ``engine_dispatches_total`` counter, labelled by schedule tag,
    and the wrapper carries ``telemetry_tag`` and ``__wrapped__``.  It
    never waits for the device, so the duration is the host's dispatch
    alone and a caller's batches in flight stay in flight; it launches
    nothing of its own.
    """
    from repro_torch import obs

    hist = count = None
    if telemetry is not None:
        hist = telemetry.registry.histogram("engine_dispatch_seconds",
                                            schedule=tag)
        count = telemetry.registry.counter("engine_dispatches_total",
                                           schedule=tag)

    def timed(ws, x):
        tel = obs.active(telemetry)
        if tel is None or _capturing():
            return apply(ws, x)
        with tel.span("apply", schedule=tag) as span:
            y = apply(ws, x)
        if hist is not None:
            hist.observe(span.duration_s)
            count.inc()
        return y

    if telemetry is not None:
        functools.update_wrapper(timed, apply)
        timed.telemetry_tag = tag
    return timed


# ---------------------------------------------------------------------------
# The measured Fig. 6 table.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerRuntime:
    """One measured row: a schedule node joined with its time.

    The schedule columns are the Hopper planner's (``LayerSchedule``):
    ``blocks`` of the launch (its reduction slices counted), ``splits``
    and the block's modeled ``smem_bytes``, in place of the JAX package's
    ``grid_steps``, ``mxu_dispatches`` and ``vmem_bytes``.  On the card
    ``measured_s`` is the device's time for the node's work and
    ``host_s`` the host's time to issue it (``_time_call``); on the CPU
    both are the host clock around the call.
    """
    name: str
    op: str                          # "deconv" | "conv" | "concat" | "add"
    macs: int                        # valid MACs at this batch
    flops: int                       # 2 * macs
    measured_s: float                # best of the repeats
    host_s: float                    # best of the repeats
    modeled_s: float                 # flops / the roof (the ideal time)
    achieved_gflops: float
    utilization: float               # achieved / roof, in [0, 1]-ish
    blocks: int
    splits: int
    smem_bytes: int

    def describe(self) -> str:
        return (f"{self.name:<18s} {self.op:<6s} "
                f"macs{self.macs:>14,d} {self.measured_s * 1e3:>9.3f}ms "
                f"host{self.host_s * 1e3:>8.3f}ms "
                f"{self.achieved_gflops:>10.1f}GF/s "
                f"util{100 * self.utilization:>7.2f}% "
                f"blocks{self.blocks:>7d} split{self.splits:>3d}")

    def to_json(self) -> dict:
        return {
            "name": self.name, "op": self.op,
            "macs": self.macs, "flops": self.flops,
            "measured_us": round(self.measured_s * 1e6, 2),
            "host_us": round(self.host_s * 1e6, 2),
            "modeled_us": round(self.modeled_s * 1e6, 4),
            "achieved_gflops": round(self.achieved_gflops, 4),
            "utilization_pct": round(100 * self.utilization, 4),
            "blocks": self.blocks,
            "splits": self.splits,
            "smem_bytes": self.smem_bytes,
        }


@dataclasses.dataclass(frozen=True)
class RuntimeReport:
    """Measured-vs-modeled utilization for one compiled network.

    ``layers`` follows schedule order (merge nodes included, zero MACs);
    ``net_wall_s`` times the whole compiled callable in one call (on the
    card its device time, ``net_host_s`` the host's time to issue it), so
    against ``sum_layer_s`` it shows what running the nodes back to back
    saves.
    """
    method: str
    network: str
    batch: int
    peak_gflops: float
    layers: tuple[LayerRuntime, ...]
    net_wall_s: float
    net_host_s: float = 0.0

    @property
    def total_macs(self) -> int:
        return sum(r.macs for r in self.layers)

    @property
    def sum_layer_s(self) -> float:
        return sum(r.measured_s for r in self.layers)

    @property
    def achieved_gflops(self) -> float:
        if self.net_wall_s <= 0:
            return 0.0
        return 2.0 * self.total_macs / self.net_wall_s / 1e9

    @property
    def utilization(self) -> float:
        """Whole-network achieved / roof — the live Fig. 6 headline."""
        if self.peak_gflops <= 0:
            return 0.0
        return self.achieved_gflops / self.peak_gflops

    def describe(self) -> str:
        head = (f"runtime[{self.method}] {self.network} batch={self.batch} "
                f"peak={self.peak_gflops:.1f}GF/s "
                f"net={self.net_wall_s * 1e3:.3f}ms "
                f"host={self.net_host_s * 1e3:.3f}ms "
                f"sum_layers={self.sum_layer_s * 1e3:.3f}ms "
                f"achieved={self.achieved_gflops:.1f}GF/s "
                f"util={100 * self.utilization:.2f}%")
        return "\n".join([head] + ["  " + r.describe() for r in self.layers])

    def to_json(self) -> dict:
        return {
            "method": self.method,
            "network": self.network,
            "batch": self.batch,
            "peak_gflops": round(self.peak_gflops, 3),
            "net_wall_us": round(self.net_wall_s * 1e6, 2),
            "net_host_us": round(self.net_host_s * 1e6, 2),
            "sum_layer_us": round(self.sum_layer_s * 1e6, 2),
            "total_macs": self.total_macs,
            "achieved_gflops": round(self.achieved_gflops, 4),
            "utilization_pct": round(100 * self.utilization, 4),
            "layers": [r.to_json() for r in self.layers],
        }


def _merge(kind: str, ins):
    if kind == "concat":
        return torch.cat(ins, dim=-1)
    out = ins[0]
    for v in ins[1:]:
        out = out + v
    return out


def measure_network(network, engine=None, ws=None, x=None, *, batch: int = 1,
                    repeats: int = 3, peak_gflops: float | None = None,
                    name: str | None = None, telemetry=None, seed: int = 0,
                    dtype: torch.dtype = torch.float32) -> RuntimeReport:
    """Run every node of a compiled network on its own and join its
    measured time against the schedule's valid MACs.

    ``network`` is a ``UniformLayer`` chain or a ``UniformGraph``;
    ``engine`` anything ``as_engine`` accepts.  ``ws`` defaults to
    ``init_network_weights`` (seeded ``seed``) and ``x`` to a normal input
    in ``dtype`` from a generator seeded ``seed + 1`` on the engine's
    device; both move to that device.  Each node is timed alone after a
    warm call, best of ``repeats``: on the card the device's time for its
    work (CUDA events on the current stream, the host's issue time kept
    out of them) and the host's time to issue it, on the CPU the host
    clock.  ``net_wall_s`` times the whole callable the same way.  The roof
    is ``peak_gflops``, else ``machine_peak_gflops`` on the engine's
    device.  With ``telemetry``, per-layer times also land in its
    ``runtime_layer_seconds`` histogram, the utilization in the
    ``runtime_utilization_pct`` gauge, and a ``measure`` span wraps the
    run.
    """
    from repro_torch.core import engine as _engine
    from repro_torch.core import networks as _networks

    eng = _engine.as_engine(engine)
    dev = eng.device
    is_graph = isinstance(network, _networks.UniformGraph)
    net_name = name or ("graph" if is_graph else "chain")
    if ws is None:
        ws = _engine.init_network_weights(
            network, torch.Generator().manual_seed(seed))
    ws = tree.tree_map(lambda t: t.to(dev), ws)
    if x is None:
        sp, cin = (network.in_shape if is_graph
                   else (tuple(network)[0].in_spatial, tuple(network)[0].cin))
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        x = 0.1 * torch.randn((batch, *sp, cin), generator=gen,
                              device=dev).to(dtype)
    x = x.to(dev)
    apply, report = _engine.compile_network(
        network, eng, batch=batch,
        dtype=x.dtype if x.dtype.is_floating_point else torch.float32)
    peak = (peak_gflops if peak_gflops is not None
            else machine_peak_gflops(device=dev))
    # name, op, macs, device seconds, host seconds
    measured: list[tuple[str, str, int, float, float]] = []

    def _measure_nodes():
        if is_graph:
            graph = network
            vals: dict[str, Any] = {graph.INPUT: x}
            for node in graph.order:
                nd = graph.nodes[node]
                ins = [vals[p] for p in graph.edges[node]]
                if isinstance(nd, _networks.MergeNode):
                    fn = functools.partial(_merge, nd.kind, ins)
                    row = (node, nd.kind, 0)
                else:
                    fn = functools.partial(_engine._run_layer, eng, nd,
                                           ws[node], ins[0])
                    row = (node, nd.op, batch * nd.valid_macs)
                measured.append((*row, *_time_call(fn, dev, repeats)))
                vals[node] = fn()
        else:
            h = x
            for layer, w in zip(network, ws):
                fn = functools.partial(_engine._run_layer, eng, layer, w, h)
                measured.append((layer.name, layer.op,
                                 batch * layer.valid_macs,
                                 *_time_call(fn, dev, repeats)))
                h = fn()

    with torch.inference_mode():
        if telemetry is not None:
            with telemetry.tracer.span("measure", network=net_name,
                                       method=eng.config.method,
                                       batch=batch):
                _measure_nodes()
        else:
            _measure_nodes()
        net_wall_s, net_host_s = _time_call(lambda: apply(ws, x), dev,
                                            repeats)

    sched = {r.name: r for r in report.layers}
    rows = []
    for node_name, op, macs, dt, host_s in measured:
        row = sched.get(node_name)
        flops = 2 * macs
        achieved = flops / dt / 1e9 if dt > 0 else 0.0
        rows.append(LayerRuntime(
            name=node_name, op=op, macs=macs, flops=flops, measured_s=dt,
            host_s=host_s,
            modeled_s=flops / (peak * 1e9) if peak > 0 else 0.0,
            achieved_gflops=achieved,
            utilization=achieved / peak if peak > 0 else 0.0,
            blocks=row.blocks if row else 0,
            splits=row.splits if row else 0,
            smem_bytes=row.smem_bytes if row else 0))
        if telemetry is not None:
            telemetry.registry.histogram(
                "runtime_layer_seconds", network=net_name,
                method=eng.config.method).observe(dt)

    out = RuntimeReport(method=eng.config.method, network=net_name,
                        batch=batch, peak_gflops=peak, layers=tuple(rows),
                        net_wall_s=net_wall_s, net_host_s=net_host_s)
    if telemetry is not None:
        telemetry.registry.gauge(
            "runtime_utilization_pct", network=net_name,
            method=eng.config.method).set(100 * out.utilization)
    return out
