"""Bulk inference: a closed loop over a pool of input batches.

Set-up draws the weights and ``pool`` distinct batches of ``batch``
inputs from the seed on the device, in ``dtype``, and runs each batch
once through the program (every shape the window uses).  The window
issues batch ``i`` (pool entry ``i mod pool``) once batch
``i - in_flight`` is done, for ``seconds``.  A batch's latency runs on
the device's clock from the moment its slot freed (the completion of
batch ``i - in_flight``, or the window's start) to its output being
ready; every batch whose output was ready inside the window counts.
``compare_batches`` batches are drawn from the seed as the window runs
(a reservoir) and their outputs kept; once the window has closed and the
program is gone, the reference recomputes them in float32."""

from __future__ import annotations

import random
import statistics
import time

import torch

from bench_dcnn import compare, data
from bench_dcnn.clock import Clock
from bench_dcnn.reference import numerics
from bench_dcnn.window import closed_loop


def run(cell) -> dict:
    cfg, mix, ref, dev = cell.config, cell.mix, cell.reference, cell.device
    dtype = getattr(torch, mix["dtype"])
    phases = {"imports": time.perf_counter() - cell.t_start}
    gen = torch.Generator(device=dev).manual_seed(cell.seed)
    params = data.draw_tree(ref.param_specs(cfg, "infer"), gen, dev, dtype)
    pool = ref.inputs(cfg, "infer", mix["pool"], mix["batch"], gen, dev,
                      dtype)
    Clock(dev).sync()
    phases["weights_inputs"] = time.perf_counter() - cell.t_start
    prog = cell.program(cfg, dev)
    for x in pool:
        prog.forward(params, x)
    clock = Clock(dev)
    clock.sync()
    phases["warm"] = time.perf_counter() - cell.t_start

    pick = random.Random(cell.seed)
    kept: list = []                    # (batch index, output)

    def issue(i, x):
        y = prog.forward(params, x)
        if len(kept) < mix["compare_batches"]:
            kept.append((i, y))
        else:
            j = pick.randrange(i + 1)
            if j < len(kept):
                kept[j] = (i, y)

    flight = mix["in_flight"]
    win = closed_loop(cell, clock, flight, lambda i: pool[i % len(pool)],
                      issue)
    peak = torch.cuda.max_memory_allocated(dev) if clock.cuda else 0

    done = win.done_ms
    window_ms = cell.window_s * 1e3
    lat = [d - (done[i - flight] if i >= flight else 0.0)
           for i, d in enumerate(done) if d <= window_ms]
    e2e = {"setup_s": win.setup_s,
           "infer_samples_per_s": len(lat) * mix["batch"] / cell.window_s}
    if len(lat) >= 20:
        e2e["infer_p95_ms"] = statistics.quantiles(lat, n=20)[18]

    del prog
    if clock.cuda:
        torch.cuda.empty_cache()
    worst = 0.0
    with numerics.ieee(), torch.no_grad():
        for i, y in kept:
            want = ref.infer(cfg, params, pool[i % len(pool)], "f32")
            worst = max(worst, compare.rel_rms(y, want))
    checks = compare.judge({"out_rel_rms": worst}, cell.limits)
    return {"e2e": e2e, "checks": checks, "attempted": len(done),
            "failed": 0 if all(c["ok"] for c in checks) else len(kept),
            "memory_peak_bytes": peak, "trace": win.trace,
            "units": len(done), "issue_s": win.issue_s,
            "batch": mix["batch"], "kind": "infer", "dtype": mix["dtype"],
            "setup_phases": phases,
            "work": ref.work(cfg, "infer")}
