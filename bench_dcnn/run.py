#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 bench_dcnn/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, this folder
and ``src/repro_torch``.  Set-up (counted as ``setup_s``, from this
process's start to the window's) draws the weights and inputs from the
seed on the card, builds the program's kernels into
``build/repro_torch_kernels/`` on a checkout's first run, and warms
every shape the cell uses; then the window runs ``--seconds``
(``--trace 1``: at most four, under ``torch.profiler``).  Once it has
closed, the plain reference checks what the timed path produced.  Prints
each number compared beside its limit as the last lines on standard
error, and one JSON object as the last line of standard output.  Exits
non-zero, printing no result, without enough CUDA devices, where the
program is missing, or if JAX or the JAX package was loaded."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, device=None) -> int:
    """``device`` (tests only) names a device to run on without looking
    for a card; the command line always looks."""
    args = _args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench_dcnn import harness
    from bench_dcnn.reference import numerics

    manifest = harness.Manifest(ROOT / "BENCHMARK.json")
    chips = manifest.cell(args.workload)["chips"]
    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < chips):
            print(f"bench_dcnn: {args.workload} needs {chips} CUDA "
                  f"device(s); found {torch.cuda.device_count()}",
                  file=sys.stderr)
            return 2
        device = "cuda:0"
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("bench_dcnn: no src/repro_torch in this checkout",
              file=sys.stderr)
        return 2
    numerics.set_ieee()
    torch.backends.cudnn.benchmark = False
    cell = harness.resolve(manifest, args.workload, seed=args.seed,
                           seconds=args.seconds, trace=bool(args.trace),
                           device=torch.device(device), t_start=T_START)
    result, checks, phases = harness.run_cell(manifest, cell)
    bad = harness.forbidden_modules()
    if bad:
        print(f"bench_dcnn: loaded {bad}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    print("setup phases " + json.dumps(phases), file=sys.stderr)
    for c in checks:
        print(f"check {c['name']} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
