#!/usr/bin/env python3
"""Readings that the limits on ``correct`` are set from, for one cell.

    python3 bench_dcnn/control.py --workload <cell> --seeds 12 \
        --control-seeds 3 [--base-seed N] [--json PATH]

In one process, at the cell's own sizes:

- ``program``: the numbers a run compares, from sound runs of the
  program on ``--seeds`` seeds (a short window for inference, none for
  training, whose numbers come from the followed steps of set-up);
- ``control``: the same numbers with the reference put in the
  program's place, computed one precision below the cell's (float8 e4m3
  for bf16 inference, TF32 for float32 training), on ``--control-seeds``
  seeds;
- ``faults``: the faults the cell can have, planted in the reference put
  in the program's place: for inference one answer altered where it is
  produced (a sample's output replaced by another sample's), for
  training half of the batch left out (the mean taken over the rest).
  A state left unchanged reads 1 on ``update_gap`` by definition.

The lower reading of a number is the largest ``program`` reading; the
upper the smallest control or fault reading that separates.  The
benchmark's own runs never run this."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _cell(harness, manifest, workload, seed, seconds, device):
    return harness.resolve(manifest, workload, seed=seed, seconds=seconds,
                           trace=False, device=device,
                           t_start=time.perf_counter())


def program_readings(manifest, workload: str, seeds, device,
                     seconds: float = 0.5) -> list[dict]:
    import importlib

    from bench_dcnn import harness
    out = []
    for seed in seeds:
        cell = _cell(harness, manifest, workload, seed, seconds, device)
        loop = importlib.import_module(f"bench_dcnn.loops.{cell.mix['kind']}")
        res = loop.run(cell)
        out.append({"seed": seed,
                    "numbers": {c["name"]: c["value"]
                                for c in res["checks"]}})
    return out


def _setup(cell, kind: str):
    import torch

    from bench_dcnn import data
    cfg, mix, ref = cell.config, cell.mix, cell.reference
    dtype = getattr(torch, mix["dtype"])
    gen = torch.Generator(device=cell.device).manual_seed(cell.seed)
    params = data.draw_tree(ref.param_specs(cfg, kind), gen, cell.device,
                            dtype)
    pool = ref.inputs(cfg, kind, mix["pool"], mix["batch"], gen,
                      cell.device, dtype)
    return params, pool


def _halved(batch: dict) -> dict:
    return {k: v[: v.shape[0] // 2] for k, v in batch.items()}


def reference_readings(manifest, workload: str, seeds, device) -> dict:
    """``control`` and ``faults`` readings, each a list over ``seeds``."""
    import torch

    from bench_dcnn import compare, harness
    from bench_dcnn.reference import numerics, training
    lower = {"bfloat16": "fp8", "float32": "tf32"}
    control, faults = [], {}
    for seed in seeds:
        cell = _cell(harness, manifest, workload, seed, 0.0, device)
        cfg, mix, ref = cell.config, cell.mix, cell.reference
        prec = lower[mix["dtype"]]
        with numerics.ieee(), torch.no_grad():
            if mix["kind"] == "infer":
                params, pool = _setup(cell, "infer")
                ctl, alt = 0.0, 0.0
                for x in pool[: mix["compare_batches"]]:
                    want = ref.infer(cfg, params, x, "f32")
                    ctl = max(ctl, compare.rel_rms(
                        ref.infer(cfg, params, x, prec), want))
                    wrong = want.clone()
                    wrong[-1] = want[0]
                    alt = max(alt, compare.rel_rms(wrong, want))
                control.append({"seed": seed, "precision": prec,
                                "numbers": {"out_rel_rms": ctl}})
                faults.setdefault("altered_answer", []).append(
                    {"seed": seed, "numbers": {"out_rel_rms": alt}})
                continue
            params, pool = _setup(cell, "train")
            n, opt = mix["followed_steps"], mix["optimizer"]
            want = training.follow(ref, cfg, params, pool[:n], opt, "f32")
            got = training.follow(ref, cfg, params, pool[:n], opt, prec)
            control.append({"seed": seed, "precision": prec,
                            "numbers": compare.training_numbers(got, want)})
            half = training.follow(ref, cfg, params,
                                   [_halved(b) for b in pool[:n]], opt, "f32")
            faults.setdefault("half_batch", []).append(
                {"seed": seed,
                 "numbers": compare.training_numbers(half, want)})
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return {"control": control, "faults": faults}


def summary(program: list, reference: dict) -> dict:
    """Per number: the lower reading (largest sound run) and the least
    reading of the control and of each fault."""
    names = program[0]["numbers"].keys()
    out = {}
    for k in names:
        row = {"lower": max(r["numbers"][k] for r in program),
               "control": min(r["numbers"][k]
                              for r in reference["control"])}
        for fault, rows in reference["faults"].items():
            row[fault] = min(r["numbers"][k] for r in rows)
        out[k] = row
    return out


def main(argv=None, device=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--base-seed", type=int, default=3_000_000_000)
    p.add_argument("--seconds", type=float, default=0.5)
    p.add_argument("--json", type=Path, default=None)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench_dcnn import harness
    from bench_dcnn.reference import numerics
    if device is None:
        if not torch.cuda.is_available():
            print("control: no CUDA device", file=sys.stderr)
            return 2
        device = "cuda:0"
    device = torch.device(device)
    numerics.set_ieee()
    manifest = harness.Manifest(ROOT / "BENCHMARK.json")
    seeds = [args.base_seed + 7919 * i for i in range(args.seeds)]
    t0 = time.perf_counter()
    prog = program_readings(manifest, args.workload, seeds, device,
                            args.seconds)
    t1 = time.perf_counter()
    ref = reference_readings(manifest, args.workload,
                             seeds[: args.control_seeds], device)
    t2 = time.perf_counter()
    out = {"workload": args.workload, "program": prog, **ref,
           "summary": summary(prog, ref),
           "seconds": {"program": t1 - t0, "reference": t2 - t1}}
    if device.type == "cuda":
        out["device"] = torch.cuda.get_device_name(device)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(out, indent=1))
    print(json.dumps({"workload": args.workload, "summary": out["summary"],
                      "seconds": out["seconds"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
