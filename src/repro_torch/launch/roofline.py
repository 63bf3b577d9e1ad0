"""The roofline table of the dry run's records (the port's counterpart of
the JAX package's ``benchmarks/roofline.py`` and
``benchmarks/assemble_experiments.py::multi_pod_summary``).

``load_records(dir, mesh)`` reads ``launch.dryrun``'s JSON records of one
mesh (``"single"`` or ``"multi"``), ``markdown_table`` gives one row per
cell with the term that dominates it and a sentence on what would move
that term, and ``multi_pod_summary`` counts the 2 x 16 x 16 pass.  A
cell fits when its memory per device is within one H100's 80 GB.

    PYTHONPATH=src python -m repro_torch.launch.roofline \
        experiments/dryrun_torch
"""

from __future__ import annotations

import json
import pathlib
import sys

DRYRUN_DIR = pathlib.Path("experiments/dryrun_torch")
H100_BYTES = 80e9            # HBM3 per card


def load_records(dryrun_dir=DRYRUN_DIR, mesh: str = "single") -> list:
    return [json.loads(p.read_text()) for p in
            sorted(pathlib.Path(dryrun_dir).glob(f"*__{mesh}.json"))]


def _next_lever(r) -> str:
    """One sentence: what would move the dominant term down."""
    rl = r["roofline"]
    dom = rl["dominant"]
    shape = r["shape"]
    moe = r["arch"].startswith(("arctic", "dbrx"))
    if shape == "dcnn":
        if dom == "collective":
            return ("gradient all-reduce / comm floor at this batch -- "
                    "int8 grad compression (runtime/dp_trainer) or a "
                    "bigger global batch")
        return ("per-card compute -- the IOM kernels already skip the "
                "S^d inserted-zero MACs")
    if dom == "collective":
        if moe:
            return "EP dispatch collectives -- shard_map MoE"
        if shape == "decode_32k":
            return ("FSDP weight all-gathers -- the decode sharding "
                    "policy")
        if rl["useful_flops_ratio"] < 0.45:
            return ("remat re-psums + CE resharding -- vocab-parallel CE; "
                    "the rest needs save_outs remat (memory budget "
                    "permitting) + async-collective overlap")
        return ("TP psums (fwd+bwd+remat) -- async-collective overlap "
                "and save_outs remat where memory allows")
    if dom == "memory":
        if shape.startswith(("decode", "long")):
            return ("weights+cache streaming (natural decode wall) -- int8 "
                    "KV cache or weight quantization next")
        return "activation traffic -- larger fused blocks / lower remat"
    if rl["useful_flops_ratio"] < 0.5:
        return ("recompute waste -- relax remat policy / causal-aware "
                "attention chunks (skip fully-masked KV)")
    return ("near useful-compute bound -- only larger per-card batch or "
            "sparsity moves this")


def markdown_table(dryrun_dir=DRYRUN_DIR, mesh: str = "single") -> str:
    lines = [
        "| arch | shape | compute_s | memory_s | collective_s | dominant |"
        " step_s | roofline_frac | useful_flops | fits_80GB |"
        " what moves the dominant term |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in load_records(dryrun_dir, mesh):
        if r.get("status") == "skipped":
            lines.append(f"| {r['arch']} | {r['shape']} | - | - | - | "
                         f"skipped | - | - | - | - | {r.get('reason', '')} |")
            continue
        if r.get("status") != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | - | - | - | "
                         f"ERROR | - | - | - | - | - |")
            continue
        rl = r["roofline"]
        fits = r["memory"]["total_per_device"] <= H100_BYTES
        lines.append(
            f"| {r['arch']} | {r['shape']} | {rl['compute_s']:.3f} | "
            f"{rl['memory_s']:.3f} | {rl['collective_s']:.3f} | "
            f"{rl['dominant']} | {rl['step_s']:.3f} | "
            f"{rl['roofline_fraction'] * 100:.1f}% | "
            f"{rl['useful_flops_ratio'] * 100:.1f}% | "
            f"{'yes' if fits else 'NO'} | {_next_lever(r)} |")
    return "\n".join(lines)


def multi_pod_summary(dryrun_dir=DRYRUN_DIR) -> str:
    recs = load_records(dryrun_dir, "multi")
    ok = sum(r.get("status") == "ok" for r in recs)
    sk = sum(r.get("status") == "skipped" for r in recs)
    er = [r for r in recs if r.get("status") == "error"]
    lines = [f"Multi-pod (2x16x16 = 512 ranks) pass: "
             f"**{ok} traced ok, {sk} skipped by design, "
             f"{len(er)} errors** out of {len(recs)} cells."]
    for r in er:
        lines.append(f"  * ERROR {r['arch']} x {r['shape']}: "
                     f"{r.get('error', '')[:200]}")
    return "\n".join(lines)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    d = argv[0] if argv else DRYRUN_DIR
    print(markdown_table(d, "single"))
    print()
    print(multi_pod_summary(d))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
