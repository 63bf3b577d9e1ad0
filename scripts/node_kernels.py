#!/usr/bin/env python3
"""Which node of a compiled network launches which device kernel, from
the program's own spans, on one NVIDIA GPU.

    python3 scripts/node_kernels.py [--model vnet|dcgan] [--batch 8]
                                    [--dtype bfloat16] [--calls 5]
                                    [--json PATH]

Warms the model's forward (``models/dcnn.py``: V-Net at 128x128x64, or
DCGAN's generator), then runs ``--calls`` more under ``torch.profiler``.
Each device kernel, copy or set is matched to the CUDA runtime call that
issued it (the profiler's correlation id), and goes to the innermost of
the program's spans (``obs.profiling_telemetry``, on the profiler's
clock) open at that call: a PyTorch kernel that serves many layers is
pinned to the node, relayout or projection that launched it.  Prints the
card's name and power limit, one row per (span, kernel) with its
launches and device ms a call, and a summary: the largest gap between a
span's start and its ``repro_torch.*`` range's, the device operations
that started before the call that issued them (0 where the device's and
the host's clocks agree) and those issued outside every span.  Exits
non-zero without a card, or when the profiler records no device time.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", choices=("vnet", "dcgan"), default="vnet")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--calls", type=int, default=5)
    p.add_argument("--json", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.core.engine import UniformEngine
    from repro_torch.models import dcnn as D

    if not torch.cuda.is_available():
        print("node_kernels: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    dtype = getattr(torch, args.dtype)
    gen = torch.Generator(device=dev).manual_seed(0)
    eng = UniformEngine(device=dev)
    if args.model == "vnet":
        cfg = get_config("v-net")
        params = _cast(D.init_vnet(cfg, gen, dev), dtype)
        x = torch.randn((args.batch, *D._vnet_spatial(cfg), 1),
                        generator=gen, device=dev).to(dtype)

        def forward():
            return D.vnet_forward(params, cfg, x, eng)
    else:
        cfg = get_config("dcgan")
        params = _cast(D.init_generator(cfg, gen, dev), dtype)
        x = torch.randn((args.batch, cfg.dcnn_z), generator=gen,
                        device=dev).to(dtype)

        def forward():
            return D.generator_forward(params, cfg, x, eng)

    with torch.inference_mode():
        for _ in range(3):
            forward()
        torch.cuda.synchronize()
        spans = obs.profiling_telemetry()     # emptied as the profile starts
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(args.calls):
                forward()
            torch.cuda.synchronize()

    recs = [r for r in spans.tracer.events() if r.get("kind") == "span"]
    opened = sorted((r["start_ns"], r["end_ns"], "repro_torch." + r["name"]
                     + ("." + str(r["of"]) if "of" in r else ""))
                    for r in recs)
    kin = prof.profiler.kineto_results.events()
    cpu = torch.autograd.DeviceType.CPU
    # the CUDA runtime's calls (cudaLaunchKernel, cuLaunchKernel, ...),
    # whose correlation ids are the device operations'
    calls = {e.correlation_id(): e for e in kin
             if e.device_type() == cpu and e.name().startswith("cu")}
    device = [e for e in kin
              if e.device_type() != cpu and not e.is_user_annotation()]
    if not device:
        print("node_kernels: the profiler recorded no device time",
              file=sys.stderr)
        return 3
    rows: dict = {}
    early = unissued = 0
    for e in device:
        call = calls.get(e.correlation_id())
        if call is None:
            unissued += 1
            owner = "(no runtime call)"
        else:
            t = call.start_ns()
            early += e.start_ns() < t
            owner = "(no span)"
            for a, b, name in opened:
                if a > t:
                    break
                if t < b:
                    owner = name           # the innermost that holds t
        n, ns = rows.get((owner, e.name()), (0, 0))
        rows[(owner, e.name())] = (n + 1, ns + e.end_ns() - e.start_ns())
    ranges: dict = {}
    for e in kin:
        if e.device_type() == cpu and e.name().startswith("repro_torch."):
            ranges.setdefault(e.name(), []).append(e.start_ns())
    gap_us = 0.0
    for a, _, name in opened:
        got = ranges.get(name)
        if got:
            gap_us = max(gap_us, min(abs(a - r) for r in got) / 1e3)
    outside = sum(n for (o, _), (n, _) in rows.items()
                  if o == "(no span)")
    total_ns = sum(ns for _, ns in rows.values())
    out = {"model": args.model, "batch": args.batch, "dtype": args.dtype,
           "calls": args.calls, "span_vs_range_max_us": gap_us,
           "started_before_issued": early, "without_runtime_call": unissued,
           "issued_outside_spans": outside,
           "rows": [{"span": r, "kernel": k[:120], "per_call":
                     n / args.calls, "ms_per_call": ns / 1e6 / args.calls,
                     "share": ns / total_ns}
                    for (r, k), (n, ns) in sorted(rows.items(),
                                                  key=lambda kv:
                                                  -kv[1][1])]}
    for row in out["rows"]:
        print(f"{row['span']:<44s} {row['per_call']:5.1f} "
              f"{row['ms_per_call']:9.4f} ms {100 * row['share']:6.2f} %  "
              f"{row['kernel'][:70]}")
    print(json.dumps({k: v for k, v in out.items() if k != "rows"}))
    if args.json:
        Path(args.json).write_text(json.dumps(out, indent=1))
    return 0


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype)


if __name__ == "__main__":
    sys.exit(main())
