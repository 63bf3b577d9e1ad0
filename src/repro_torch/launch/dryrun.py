"""Multi-pod dry run (JAX ``launch/dryrun.py``): trace every (architecture
x input shape) cell on the production meshes, as rank 0 of them, and
record its roofline, collectives and memory per device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \
        --dcnn --no-probe --out experiments/dryrun_torch

Nothing is allocated and no world is joined: the mesh is the layout
alone (``launch.mesh.make_production_mesh(world=False)``), the
parameters, optimizer state, batch and cache are this rank's ``meta``
blocks (``launch.steps.build_bundle``), and the step runs once on them
(``launch.analysis.analyse_step``).  The reference compiles on 512 host
devices and sets ``XLA_FLAGS`` at import; this module sets nothing.

The port traces every layer, so the full trace's totals are exact.  The
probes (``_probe_plan``: the step traced at two depths, extrapolated
linearly to the full one) are kept as the reference has them, so that
``probe`` means the same thing in both records.  Their FLOPs and
collective bytes are the full trace's (without ``remat_segments``,
which nests the remat differently at a probe's depth); their op-by-op
bytes fall short of it in a train step, whose backward of a stacked
layer leaf's index makes a whole ``[L, ...]`` gradient for each layer.
"""

from __future__ import annotations

import argparse
import dataclasses as _dc
import json
import pathlib
import time
import traceback

from repro_torch.configs import ASSIGNED, PAPER_DCNNS, SHAPES, get_config
from repro_torch.configs.base import shape_applicable
from repro_torch.launch import steps as ST
from repro_torch.launch.analysis import (
    Roofline,
    analyse_step,
    analytic_hbm_bytes,
    model_flops_estimate,
    trace_step,
    tree_bytes,
)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import flags as _flags
from repro_torch.models.transformer import _XENT_CHUNK


def _probe_plan(cfg):
    """(L1, L2) probe layer counts for a linear extrapolation of the
    per-layer cost (the reference's plan); None for a DCNN (no layer
    loop)."""
    if cfg.family == "dcnn":
        return None
    period = max(cfg.attn_every, cfg.slstm_every, 1)
    if cfg.n_layers <= 2 * period and cfg.n_layers <= 8:
        return (cfg.n_layers, cfg.n_layers)  # exact full depth
    return (period, 2 * period) if period > 1 else (1, 2)


def _analytic_bytes(cfg, shape, mesh, bundle):
    """Inputs for the fused-traffic estimate (``analysis``)."""
    model_sh = mesh.shape.get("model", 1)
    data_sh = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
    n_params = bundle.meta["params"]
    p_shards = model_sh * (data_sh if cfg.fsdp else 1)
    if cfg.family == "dcnn":
        return analytic_hbm_bytes(
            "train", n_params=n_params, param_shards=p_shards,
            tokens_local=cfg.dcnn_batch * 64 * 64 // data_sh,
            d_model=64, n_layers=8, opt_bits=cfg.opt_state_bits)
    tokens = shape.global_batch * (shape.seq_len
                                   if shape.kind != "decode" else 1)
    tokens_local = max(tokens // data_sh, 1)
    cache_local = 0
    if shape.kind == "decode":
        c_shapes, _ = ST.cache_specs(cfg, shape, mesh)
        cache_local = tree_bytes(c_shapes) // mesh.size
    xent_chunks = max(tokens // _XENT_CHUNK, 1) if shape.kind == "train" \
        else 0
    return analytic_hbm_bytes(
        shape.kind, n_params=bundle.meta.get("active_params", n_params),
        param_shards=p_shards, tokens_local=tokens_local,
        d_model=cfg.d_model, n_layers=max(cfg.n_layers, 1),
        vocab_local=cfg.vocab // model_sh, xent_chunks=xent_chunks,
        cache_bytes_local=cache_local, opt_bits=cfg.opt_state_bits)


def _probe_metrics(cfg, shape, mesh, plan):
    """The step traced at two depths -> per-device totals at the full
    depth, extrapolated linearly."""
    def measure(n_layers):
        pcfg = _dc.replace(cfg, n_layers=n_layers, scan_layers=False)
        with _flags.unrolled():
            bundle = ST.build_bundle(pcfg, shape, mesh, policy=False)
            _, c = trace_step(bundle.fn, bundle.args, mesh)
        return {"flops": float(c["product_flops"] + c["kernel_flops"]),
                "bytes": float(c["accessed_bytes"]),
                "coll": float(c["collectives"]["total_bytes"])}

    l1, l2 = plan
    m1 = measure(l1)
    if l2 == l1:   # exact full depth
        return m1, {"probe_layers": [l1], "exact": True}
    m2 = measure(l2)
    per_layer = {k: (m2[k] - m1[k]) / (l2 - l1) for k in m1}
    total = {k: m1[k] + per_layer[k] * (cfg.n_layers - l1) for k in m1}
    return total, {"probe_layers": [l1, l2], "exact": False,
                   "per_layer": per_layer}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             probe: bool = True, cfg=None) -> dict:
    """One cell's record (``cfg``: the config to run, by default
    ``get_config(arch)``)."""
    cfg = cfg if cfg is not None else get_config(arch)
    mesh = make_production_mesh(multi_pod=multi_pod, world=False)
    chips = mesh.size
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16", "chips": chips}

    if cfg.family == "dcnn":
        shape = None
        kind = "train"
    else:
        shape = SHAPES[shape_name]
        kind = shape.kind
        ok, why = shape_applicable(cfg, shape)
        if not ok:
            rec.update(status="skipped", reason=why)
            return rec

    t0 = time.time()
    try:
        bundle = ST.build_bundle(cfg, shape, mesh)
        if cfg.family == "dcnn":
            tokens = bundle.meta["cfg"].dcnn_batch
            n_active = bundle.meta["params"]
        else:
            tokens = shape.global_batch * (shape.seq_len
                                           if kind != "decode" else 1)
            n_active = bundle.meta.get("active_params",
                                       bundle.meta["params"])
        mf = model_flops_estimate(kind, n_active, tokens)
        # the estimate of the config as named (the reference's)
        ab = _analytic_bytes(cfg, shape, mesh, bundle)
        alias = [bundle.args[i] for i in bundle.meta["donate"]]
        _, res = analyse_step(bundle.fn, bundle.args, mesh, chips, mf, ab,
                              alias=alias)
        rl = res["roofline"]
        print(f"[{arch} x {shape_name} x {rec['mesh']}] memory: "
              f"{res['memory']}")
        print(f"[{arch} x {shape_name} x {rec['mesh']}] flops="
              f"{rl['flops_per_device']} bytes={rl['bytes_per_device']} "
              f"collective_bytes={rl['collective_bytes_per_device']}")
        rec.update(status="ok", trace_s=round(time.time() - t0, 1),
                   params=bundle.meta["params"], active_params=n_active,
                   tokens=tokens, **res)
        if cfg.family == "dcnn":
            rec["partition"] = bundle.meta["partition"]
        if probe and _probe_plan(cfg) is not None:
            t1 = time.time()
            totals, pinfo = _probe_metrics(bundle.meta["cfg"], shape, mesh,
                                           _probe_plan(cfg))
            rec["roofline"] = Roofline(
                flops_per_device=totals["flops"],
                bytes_per_device=totals["bytes"],
                collective_bytes_per_device=totals["coll"],
                chips=chips, model_flops=mf,
                analytic_bytes_per_device=ab).to_dict()
            rec["probe"] = {**pinfo,
                            "probe_trace_s": round(time.time() - t1, 1)}
    except Exception as e:  # noqa: BLE001 -- record the failure, go on
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:],
                   trace_s=round(time.time() - t0, 1))
    return rec


def cells(args) -> list[tuple[str, str]]:
    """The (arch, shape) cells the command line names."""
    if args.all:
        out = [(arch, shape) for arch in ASSIGNED for shape in SHAPES]
        if args.dcnn:
            out += [(a, "dcnn") for a in PAPER_DCNNS]
        return out
    if not args.arch:
        raise SystemExit("--arch or --all required")
    shapes = [args.shape] if args.shape else list(SHAPES)
    return [(args.arch, s) for s in shapes]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=[*SHAPES, "dcnn"])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true",
                    help="run every (assigned arch x shape) cell")
    ap.add_argument("--dcnn", action="store_true",
                    help="include the paper's DCNN configs")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--no-probe", action="store_true",
                    help="the full trace only (multi-pod proof pass)")
    args = ap.parse_args(argv)

    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    n_ok = n_skip = n_err = 0
    for arch, shape in cells(args):
        for mp in meshes:
            tag = f"{arch.replace('.', '_')}__{shape}__" \
                  f"{'multi' if mp else 'single'}"
            path = outdir / f"{tag}.json"
            if path.exists():
                rec = json.loads(path.read_text())
                if rec.get("status") == "ok":
                    print(f"skip cached {tag}")
                    n_ok += 1
                    continue
            rec = run_cell(arch, shape, mp, probe=not args.no_probe)
            path.write_text(json.dumps(rec, indent=1))
            st = rec["status"]
            n_ok += st == "ok"
            n_skip += st == "skipped"
            n_err += st == "error"
            msg = rec.get("error", rec.get("reason", ""))
            print(f"{tag:<50s} {st:<8s} {rec.get('trace_s', '')} {msg}",
                  flush=True)
    print(f"done: ok={n_ok} skipped={n_skip} errors={n_err}")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
