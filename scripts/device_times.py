#!/usr/bin/env python3
"""Device time of the forward kernels' launches at training shapes, on
one NVIDIA GPU, for one or more ``src`` trees in turns.

    python3 scripts/device_times.py --src A/src [--src B/src ...]
                                    [--dtype bfloat16] [--json PATH]

Many of the main path's launches are short (0.05-0.2 ms), and CUDA
events around back-to-back wrapper calls time the wrapper's host work
there, which varies from run to run by more than the kernels differ.
This reads the kernels' own device time instead: every conv and deconv
layer of the DCGAN generator and discriminator (batch 32, a
data-parallel rank's, and 64, the trainer's) and of V-Net (batch 4),
its forward and its dx launch in ``--dtype``, 20 launches each under
``torch.profiler`` (CUPTI), each launch's device time the sum of its
``igemm`` kernels' (the main pass and, when split, the slices' sum),
beside CUDA events around the same 20 launches.  Each tree runs in its
own process, the trees in the order given, then reversed.  Prints the
card's name and power limit, one JSON line per tree and turn (per-layer
times under ``--json``) and, last, the sums per tree and turn.  Exits
non-zero without a card, or when the profiler records no device time.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CALLS = 20


def child(src: Path, dtype_name: str) -> int:
    sys.path.insert(0, str(src))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core.engine import UniformEngine
    from repro_torch.kernels.conv import kernel as ck
    from repro_torch.kernels.conv import ops as cops
    from repro_torch.kernels.deconv import kernel as dk
    from repro_torch.kernels.deconv import ops as dops
    from repro_torch.launch import steps as ST

    dev = torch.device("cuda")
    dtype = getattr(torch, dtype_name)
    engine = UniformEngine(device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(
            dtype)

    cells = [(f"dcgan.{g}", l, b)
             for g, graph in ST.train_graphs(get_config("dcgan")).items()
             for l in graph.layers for b in (32, 64)]
    cells += [("vnet", l, 4)
              for l in ST.train_graphs(get_config("v-net"))["vnet"].layers]
    rows = []
    for model, layer, batch in cells:
        if layer.empty:
            continue
        x = rand((batch, *layer.in_spatial, layer.cin))
        w = rand(layer.weight_shape,
                 1.0 / math.sqrt(math.prod(layer.weight_shape[:-1])))
        dy = rand((batch, *layer.out_spatial, layer.cout))
        fwd_args = (dops.deconv_kernel_args if layer.op == "deconv"
                    else cops.conv_kernel_args)
        fwd_kernel = dk.deconv_fwd if layer.op == "deconv" else ck.conv_fwd
        x3, wk, kw, _ = fwd_args(x, w, layer.stride, layer.padding,
                                 dilation=layer.dilation,
                                 groups=layer.groups, engine=engine)
        back = (dops.deconv_backward_args if layer.op == "deconv"
                else cops.conv_backward_args)
        (a, b, dkw), _ = back(x, w, dy, layer.stride, layer.padding,
                              dilation=layer.dilation, groups=layer.groups,
                              engine=engine, dw=False)
        dx_kernel = dk.deconv_dx if layer.op == "deconv" else dk.deconv_fwd
        for which, fn in (("fwd", lambda: fwd_kernel(x3, wk, **kw)),
                          ("dx", lambda: dx_kernel(a, b, **dkw))):
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(CALLS):
                    fn()
                torch.cuda.synchronize()
            dev_us = 0.0
            for evt in prof.key_averages():
                if "igemm" in evt.key:
                    dev_us += getattr(evt, "device_time_total",
                                      getattr(evt, "cuda_time_total", 0.0))
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(CALLS):
                fn()
            e1.record()
            e1.synchronize()
            rows.append({"model": model, "layer": layer.name, "batch": batch,
                         "grad": which, "device_ms": dev_us / 1e3 / CALLS,
                         "event_ms": e0.elapsed_time(e1) / CALLS})
        del x, w, dy, x3, wk, a, b
    torch.cuda.empty_cache()
    print(json.dumps({"rows": rows}))
    return 0 if all(r["device_ms"] > 0 for r in rows) else 1


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--src", type=Path, action="append", required=True)
    parser.add_argument("--dtype", default="bfloat16",
                        choices=("float32", "bfloat16"))
    parser.add_argument("--json", type=Path,
                        default=ROOT / "build" / "device_times.json")
    parser.add_argument("--child", type=Path, default=None,
                        help=argparse.SUPPRESS)
    cli = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("device_times: no CUDA device", file=sys.stderr)
        return 2
    if cli.child is not None:
        return child(cli.child, cli.dtype)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    runs, rc = [], 0
    for src in cli.src + cli.src[::-1]:
        proc = subprocess.run(
            [sys.executable, __file__, "--child", str(src), "--dtype",
             cli.dtype, "--src", str(src)], capture_output=True, text=True,
            timeout=1200)
        rows = [json.loads(x)["rows"] for x in proc.stdout.splitlines()
                if x.startswith('{"rows"')]
        if proc.returncode != 0 or not rows:
            print(f"== {src} rc {proc.returncode}\n{proc.stderr[-3000:]}")
            rc = 1
            continue
        sums = {}
        for r in rows[0]:
            key = f"{r['model'].split('.')[0]}:b{r['batch']}:{r['grad']}"
            s = sums.setdefault(key, [0.0, 0.0])
            s[0] += r["device_ms"]
            s[1] += r["event_ms"]
        run = {"src": str(src), "sums_device_event_ms": sums}
        print(json.dumps(run), flush=True)
        runs.append(dict(run, rows=rows[0]))
    cli.json.parent.mkdir(parents=True, exist_ok=True)
    cli.json.write_text(json.dumps({"card": card, "dtype": cli.dtype,
                                    "runs": runs}, indent=1))
    return rc


if __name__ == "__main__":
    sys.exit(main())
