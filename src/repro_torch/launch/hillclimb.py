"""Hill-climb runner (JAX ``launch/hillclimb.py``): trace one (arch x
shape) cell with config overrides and write
``experiments/hillclimb_torch/<tag>.json``; the dry run's records stay
as they are.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb \
        --arch llama3.2-1b --shape train_4k --tag llama_saveouts \
        --set remat_policy=save_outs

Like the dry run it needs no world, no card and no allocation, and it
sets no environment variable.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib

from repro_torch.configs import get_config
from repro_torch.launch import dryrun as DR


def parse_value(v: str):
    """An override's value: an int, a float, a bool or the string."""
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    if v in ("true", "True"):
        return True
    if v in ("false", "False"):
        return False
    return v


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--tag", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    help="cfg override key=value (repeatable)")
    ap.add_argument("--out", default="experiments/hillclimb_torch")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = parse_value(v)
    cfg = dataclasses.replace(get_config(args.arch), **overrides)

    rec = DR.run_cell(args.arch, args.shape, args.multi_pod, probe=True,
                      cfg=cfg)
    rec["overrides"] = overrides
    rec["tag"] = args.tag
    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    (outdir / f"{args.tag}.json").write_text(json.dumps(rec, indent=1))
    rl = rec.get("roofline", {})
    print(json.dumps({k: rl.get(k) for k in
                      ("compute_s", "memory_s", "collective_s", "dominant",
                       "step_s", "roofline_fraction",
                       "useful_flops_ratio")}, indent=1))
    print("status:", rec["status"], rec.get("error", ""))
    return rec


if __name__ == "__main__":
    main()
