"""The autotuning sweep: search tile plans for the bench networks on
the card, persist the tuned-plan cache, prove the zero-search reload (the
JAX package's ``launch/tune.py``).

    PYTHONPATH=src python -m repro_torch.launch.tune \\
        [--networks dcgan,vnet_graph] [--out build/tuned_plans.json] \\
        [--batch 4] [--weight-quant int8] [--trials 64] \\
        [--measure-topk 3] [--repeats 3] [--seed 0] [--model-only] \\
        [--resume] [--set mem_bps=3e12] [--device cuda|cpu]

Flow:

  1. build the networks: ``dcgan`` and ``vnet_graph`` at the published
     widths (the graphs the server runs), or ``dcgan_gen`` / ``vnet``,
     the JAX package's reduced bench chains;
  2. ``tune.tune_network`` each: enumerate the design space, rank it
     under the latency model (calibrated on the device unless
     ``--model-only``), measure the top-k and the heuristic on the card,
     keep the winners;
  3. persist the ``TunedPlanCache`` to ``--out``;
  4. reload the file into a fresh telemetry-instrumented engine per
     network and ``compile_network`` it again, asserting every plan came
     from the cache (``engine_plan_tuned_hits_total`` == planned layers,
     ``engine_plan_heuristic_total`` == 0).

``--device`` is ``cuda`` by default and raises without a card; ``cpu``
runs the kernels' plain versions (the tests' setting, where a measured
time says nothing of the card).  ``--set key=value`` overrides
``LatencyModel`` fields.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time

from repro_torch import tune
from repro_torch.core import networks


def parse_value(v: str):
    """A ``--set`` value: int, then float, then a boolean word, else the
    string (the JAX package's ``launch/hillclimb.py::parse_value``)."""
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


def bench_networks() -> dict:
    """The networks the sweep knows: the published-width DCGAN generator
    chain and V-Net graph, and the JAX package's reduced bench pair (one
    definition with ``benchmarks/kernel_bench.py`` there)."""
    gen = networks.deconv_stack("dcgan", 2, 4, [32, 16, 8, 4, 3])
    vnet = networks.conv_stack("vnet", (8, 8, 8),
                               [(1, 4), (4, 8), (8, 16)])
    sp = vnet[-1].out_spatial
    for i, (ci, co) in enumerate([(16, 8), (8, 4)]):
        vnet.append(networks.UniformLayer(
            name=f"vnet.up{i + 1}", in_spatial=sp, cin=ci, cout=co,
            kernel=(3,) * 3, stride=(2,) * 3, padding=((0, 1),) * 3,
            op="deconv"))
        sp = vnet[-1].out_spatial
    return {"dcgan": networks.dcgan(), "vnet_graph": networks.vnet_graph(),
            "dcgan_gen": gen, "vnet": vnet}


def verify_zero_search(cache: tune.TunedPlanCache, nets: dict, *,
                       device="cuda", precision=None) -> dict:
    """Build a fresh engine per network from ``cache`` and compile: every
    plan must be a tuned hit, no heuristic fallback.  Returns the
    per-network telemetry counts (raises on a violation)."""
    from repro_torch import obs
    from repro_torch.core.engine import (
        EngineConfig,
        UniformEngine,
        compile_network,
    )

    out = {}
    for name, net in nets.items():
        tel = obs.Telemetry.create()
        eng = UniformEngine(EngineConfig(tuned_plans=cache, telemetry=tel,
                                         precision=precision, device=device))
        compile_network(net, eng)

        def count(metric):
            m = tel.registry.get(metric)
            return m.value if m is not None else 0

        tuned = count("engine_plan_tuned_hits_total")
        heur = count("engine_plan_heuristic_total")
        if heur or tuned != len(eng.plan_cache):
            raise AssertionError(
                f"{name}: reload was not search-free "
                f"(tuned={tuned}, heuristic={heur}, "
                f"plans={len(eng.plan_cache)})")
        out[name] = {"tuned_hits": int(tuned), "heuristic": int(heur),
                     "plans": len(eng.plan_cache)}
    return out


def main(argv=None) -> int:
    from repro_torch.quant import Precision

    all_nets = bench_networks()
    ap = argparse.ArgumentParser()
    ap.add_argument("--networks", default="dcgan,vnet_graph",
                    help="comma list from: %s" % ",".join(all_nets))
    ap.add_argument("--out", default="build/tuned_plans.json")
    ap.add_argument("--batch", type=int, default=1,
                    help="the batch the candidates are measured at")
    ap.add_argument("--weight-quant", choices=("none", "int8"),
                    default="none",
                    help="tune the geometries of an int8-weight engine")
    ap.add_argument("--trials", type=int, default=64)
    ap.add_argument("--measure-topk", type=int, default=3)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model-only", action="store_true",
                    help="rank by the nominal model only (no measurement, "
                         "no probe): fully deterministic")
    ap.add_argument("--resume", action="store_true",
                    help="load --out first and only tune geometries it "
                         "does not already cover")
    ap.add_argument("--set", action="append", default=[],
                    help="LatencyModel override field=value (repeatable)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    names = [n.strip() for n in args.networks.split(",") if n.strip()]
    unknown = sorted(set(names) - set(all_nets))
    if unknown:
        ap.error(f"unknown networks {unknown}; have {sorted(all_nets)}")
    nets = {n: all_nets[n] for n in names}
    prec = Precision(weight_quant=args.weight_quant)

    model = (tune.LatencyModel() if args.model_only
             else tune.LatencyModel.calibrate(device=args.device))
    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = parse_value(v)
    if overrides:
        model = dataclasses.replace(model, **overrides)

    out_path = pathlib.Path(args.out)
    cache = (tune.TunedPlanCache.load(out_path)
             if args.resume and out_path.exists() else tune.TunedPlanCache())
    topk = 0 if args.model_only else args.measure_topk

    t0 = time.perf_counter()
    summaries = {}
    for name, net in nets.items():
        cache, results = tune.tune_network(
            net, trials=args.trials, measure_topk=topk,
            repeats=args.repeats, seed=args.seed, model=model,
            batch=args.batch, device=args.device, precision=prec,
            cache=cache)
        for r in results:
            print(r.describe())
        summaries[name] = [r.to_json() for r in results]
    sweep_s = time.perf_counter() - t0

    cache.meta.update({
        "networks": names, "batch": args.batch,
        "weight_quant": args.weight_quant, "trials": args.trials,
        "measure_topk": topk, "repeats": args.repeats, "seed": args.seed,
        "device": args.device, "sweep_s": sweep_s,
        "model": dataclasses.asdict(model),
    })
    cache.save(out_path)
    print(f"wrote {out_path} ({len(cache)} tuned geometries, "
          f"{sweep_s:.1f}s sweep)")

    reloaded = tune.TunedPlanCache.load(out_path, strict=True)
    counts = verify_zero_search(reloaded, nets, device=args.device,
                                precision=prec)
    print(json.dumps({"out": str(out_path), "entries": len(reloaded),
                      "zero_search_reload": counts,
                      "tuned": summaries}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
