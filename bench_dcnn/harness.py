"""The general harness: one cell of ``BENCHMARK.json`` run once.

Everything that belongs to one configuration, traffic mix or metric sits
in files of its own, found by the names in ``BENCHMARK.json``:

- a configuration's sizes in the file its entry names, its model family
  (``model``) choosing ``reference/<model>.py`` (the plain reference:
  graph, weights' shapes, inputs, forward, loss) and ``models/<model>.py``
  (the program's entry points);
- a traffic mix in ``traffic/<mix>.json``, its ``kind`` choosing
  ``loops/<kind>.py``;
- a cell's limits on the numbers that decide ``correct`` in
  ``limits/<cell>.json``;
- a per-layer metric in ``metrics/<metric>.py``: ``read(ctx)`` returns
  the metric's value, or None where it finds nothing to read.

``run_cell`` returns the result line's object, the checks (each number
compared beside its limit) and the set-up's phases (seconds from the
process's start at the end of each)."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACE_SECONDS = 4.0


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


class Manifest:
    def __init__(self, path: Path):
        self.root = path.resolve().parent
        self.data = load_json(path)

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def end_to_end(self, cell: str) -> list[dict]:
        return [m for m in self.data["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]]

    def per_layer(self, cell: str) -> list[dict]:
        """The per-layer metrics whose ``workloads`` list the cell."""
        return [m for m in self.data["per_layer"]
                if cell in m.get("workloads", ())]


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    limits: dict
    reference: object
    program: type
    seed: int
    window_s: float
    trace: bool
    device: object
    t_start: float


def load_metric(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_dcnn.metrics._" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(manifest: Manifest, workload: str, *, seed: int, seconds: float,
            trace: bool, device, t_start: float) -> Cell:
    entry = manifest.cell(workload)
    cfg = load_json(manifest.root / manifest.config(entry["config"])["file"])
    mix = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{workload}.json")
    ref = importlib.import_module(f"bench_dcnn.reference.{cfg['model']}")
    prog = importlib.import_module(f"bench_dcnn.models.{cfg['model']}")
    window = min(seconds, TRACE_SECONDS) if trace else seconds
    return Cell(name=workload, config=cfg, mix=mix, limits=limits,
                reference=ref, program=prog.Program, seed=seed,
                window_s=float(window), trace=trace, device=device,
                t_start=t_start)


@dataclasses.dataclass
class Context:
    """What a per-layer metric reads: the traced window and the work
    done in it."""
    kind: str
    dtype: str
    batch: int
    units: int           # batches or steps issued, all done in the window
    work: list           # the reference's (node, passes) of one unit
    window_s: float
    busy_s: float
    kernels: list        # (name, activity, start_ns, end_ns)
    host_s: dict         # the benchmark's spans: seconds on the host


def _breakdown(trace) -> dict:
    return {"device_ops": [[n[:160], s] for n, s in trace.by_name()[:10]],
            "idle_gaps": [[n, s] for n, s in trace.gaps[:10]]}


def run_cell(manifest: Manifest, cell: Cell) -> tuple[dict, list[dict]]:
    import torch

    loop = importlib.import_module(f"bench_dcnn.loops.{cell.mix['kind']}")
    out = loop.run(cell)
    dev = cell.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
              "count": 1, "memory_peak_bytes": int(out["memory_peak_bytes"])}
    metrics = {}
    result = {"correct": all(c["ok"] for c in out["checks"]),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device}
    trace = out["trace"]
    if trace is None:
        for m in manifest.end_to_end(cell.name):
            if m["name"] in out["e2e"]:
                metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                      "unit": m["unit"]}
    else:
        device["busy_s"] = trace.busy_s
        device["window_s"] = trace.window_s
        ctx = Context(kind=out["kind"], dtype=out["dtype"],
                      batch=out["batch"], units=out["units"],
                      work=out["work"], window_s=trace.window_s,
                      busy_s=trace.busy_s, kernels=trace.kernels,
                      host_s=trace.host_s)
        for m in manifest.per_layer(cell.name):
            value = load_metric(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = _breakdown(trace)
    if dev.type == "cuda":
        device["power_limit_w"] = _power_limit()
    phases = dict(out["setup_phases"], window_start=out["e2e"]["setup_s"])
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in out["checks"]}
    return result, out["checks"], phases


def _power_limit():
    """The card's power limit in watts (``nvidia-smi``), or None."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (``repro``; ``repro_torch`` is another name)."""
    return sorted(k for k in sys.modules if k.split(".")[0] in FORBIDDEN)
