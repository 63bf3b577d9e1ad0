"""Training: one train step after another over a pool of batches.

Set-up draws the weights and ``pool`` distinct batches from the seed on
the device, builds the program's step and optimizer state once, and
drives that same step through its first ``followed_steps`` steps on pool
entries 0, 1, ... (rows that all differ), which also warms every shape.
The window then carries on with the same objects, step ``k`` on pool
entry ``k mod pool``, keeping at most ``in_flight`` steps queued, for
``seconds``; every step whose update was done inside the window counts,
on the device's clock.  Once the window has closed, the reference
follows the first steps from the same weights and batches, and the
comparison takes each step's losses, the first gradient (from the
optimizer's first moment after one step) and each leaf's change over
the followed steps."""

from __future__ import annotations

import time

import torch

from bench_dcnn import compare, data
from bench_dcnn.clock import Clock
from bench_dcnn.reference import numerics, training
from bench_dcnn.reference.numerics import map_tree, named_leaves
from bench_dcnn.window import closed_loop


def program_readings(params0, first_losses, m1, params_n,
                     b1: float) -> dict:
    """What the program's first steps gave, in the reference's terms."""
    start = named_leaves(params0)
    return {
        "losses": [{k: float(t) for k, t in ls.items()}
                   for ls in first_losses],
        "grad_norms": {k: float(t.to(torch.float32).norm()) / (1 - b1)
                       for k, t in named_leaves(m1).items()},
        "change_norms": {k: float((t.to(torch.float32)
                                   - start[k].to(torch.float32)).norm())
                         for k, t in named_leaves(params_n).items()},
    }


def run(cell) -> dict:
    cfg, mix, ref, dev = cell.config, cell.mix, cell.reference, cell.device
    dtype = getattr(torch, mix["dtype"])
    opt = mix["optimizer"]
    phases = {"imports": time.perf_counter() - cell.t_start}
    gen = torch.Generator(device=dev).manual_seed(cell.seed)
    params = data.draw_tree(ref.param_specs(cfg, "train"), gen, dev, dtype)
    pool = ref.inputs(cfg, "train", mix["pool"], mix["batch"], gen, dev,
                      dtype)
    params0 = map_tree(torch.clone, params)     # the benchmark's own copy
    Clock(dev).sync()
    phases["weights_inputs"] = time.perf_counter() - cell.t_start
    prog = cell.program(cfg, dev)
    step = prog.train_step(opt)
    state = prog.opt_init(params, opt)
    followed = mix["followed_steps"]
    first_losses, m1 = [], None
    for k in range(followed):
        params, state, metrics = step(params, state, pool[k % len(pool)])
        first_losses.append(prog.losses(metrics))
        if k == 0:
            m1 = prog.first_moments(state)
    params_n = params
    clock = Clock(dev)
    clock.sync()
    phases["warm"] = time.perf_counter() - cell.t_start

    live = {"params": params, "state": state}

    def issue(i, batch):
        live["params"], live["state"], _ = step(live["params"],
                                                 live["state"], batch)

    win = closed_loop(cell, clock, mix["in_flight"],
                      lambda i: pool[(followed + i) % len(pool)], issue)
    peak = torch.cuda.max_memory_allocated(dev) if clock.cuda else 0

    n_done = sum(d <= cell.window_s * 1e3 for d in win.done_ms)
    e2e = {"setup_s": win.setup_s,
           "train_samples_per_s": n_done * mix["batch"] / cell.window_s}

    got = program_readings(params0, first_losses, m1, params_n, opt["b1"])
    del prog, step, state, params, params_n, m1, live
    if clock.cuda:
        torch.cuda.empty_cache()
    with numerics.ieee():
        want = training.follow(ref, cfg, params0, pool[:followed], opt,
                               "f32")
    checks = compare.judge(compare.training_numbers(got, want), cell.limits)
    return {"e2e": e2e, "checks": checks,
            "attempted": len(win.done_ms) + followed,
            "failed": 0 if all(c["ok"] for c in checks) else followed,
            "memory_peak_bytes": peak, "trace": win.trace,
            "units": len(win.done_ms), "issue_s": win.issue_s,
            "batch": mix["batch"], "kind": "train", "dtype": mix["dtype"],
            "setup_phases": phases,
            "work": ref.work(cfg, "train")}
