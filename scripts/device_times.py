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
data-parallel rank's, and 64, the trainer's), of V-Net (batch 4) and of
the 3D-GAN's train graphs (batch 32), its forward and its dx launch in
``--dtype``, 20 launches each under ``torch.profiler`` (CUPTI), each
launch's device time the sum of its ``igemm`` kernels' (the main pass
and, when split, the slices' sum), beside CUDA events around the same
20 launches, how the launch staged A (``staging``: ``gather`` or
``halo``, as the wrapper's ``staging_launches`` recorded it; a tree
without that record gathers), and for the forward the device time of
one cuDNN call of the same layer (``cudnn_ms``: channels-last, the
deconv uncropped, as chip_smoke.py's yardstick).  Each tree runs in its
own process, the trees in the order given, then reversed.  Prints the
card's name and power limit, each tree's per-layer rows on its first
turn, one JSON line per tree and turn (everything under ``--json``)
and, last, the sums per tree and turn.  Exits non-zero without a card,
or when the profiler records no device time.
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

    F = torch.nn.functional
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
    cells += [(f"3d_gan.{g}", l, get_config("3d_gan").dcnn_batch)
              for g, graph in ST.train_graphs(get_config("3d_gan")).items()
              for l in graph.layers]

    def device_ms(fn, match):
        """Device time of one call of ``fn``: kernels whose name holds
        ``match`` (all when None) over CALLS calls, under the profiler."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
        cuda = torch.autograd.DeviceType.CUDA
        us = 0.0
        for evt in prof.key_averages():      # kernels, not their launches
            if getattr(evt, "device_type", cuda) == cuda and (
                    match is None or match in evt.key):
                us += getattr(evt, "device_time_total",
                              getattr(evt, "cuda_time_total", 0.0))
        return us / 1e3 / CALLS

    def cudnn_call(layer, x, w):
        """One cuDNN call of the layer's forward, channels-last (the
        deconv uncropped), layouts permuted outside the timed calls."""
        r = layer.rank
        fmt = torch.channels_last if r == 2 else torch.channels_last_3d
        xl = x.permute(0, r + 1, *range(1, r + 1))
        if layer.op == "deconv":
            wl = w.permute(r, r + 1, *range(r)).contiguous(memory_format=fmt)
            fn = F.conv_transpose2d if r == 2 else F.conv_transpose3d
            return lambda: fn(xl, wl, stride=layer.stride,
                              dilation=layer.dilation, groups=layer.groups)
        wl = w.permute(r + 1, r, *range(r)).contiguous(memory_format=fmt)
        fn = F.conv2d if r == 2 else F.conv3d
        pad = tuple(lo for lo, _ in layer.padding)
        return lambda: fn(xl, wl, stride=layer.stride, padding=pad,
                          dilation=layer.dilation, groups=layer.groups)

    def staged():
        out = {}
        for mod in (ck, dk):
            for key, n in getattr(mod, "staging_launches", {}).items():
                out[key[3]] = out.get(key[3], 0) + n
        return out

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
            before = staged()
            fn()
            how = [k for k, n in staged().items() if n != before.get(k, 0)]
            dev_ms = device_ms(fn, "igemm")
            cudnn_ms = None
            if which == "fwd" and layer.groups == 1:
                cudnn_ms = device_ms(cudnn_call(layer, x, w), None)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(CALLS):
                fn()
            e1.record()
            e1.synchronize()
            rows.append({"model": model, "layer": layer.name, "batch": batch,
                         "grad": which, "device_ms": dev_ms,
                         "event_ms": e0.elapsed_time(e1) / CALLS,
                         "staging": how[0] if len(how) == 1 else "gather",
                         "cudnn_ms": cudnn_ms})
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
        if str(src) not in [r["src"] for r in runs]:
            for r in rows[0]:
                cud = ("" if r["cudnn_ms"] is None
                       else f" cudnn {r['cudnn_ms']:.4f}")
                print(f"  {r['model']}:{r['layer']}:b{r['batch']}:"
                      f"{r['grad']} {r['staging']} {r['device_ms']:.4f}"
                      f"{cud}")
        print(json.dumps(run), flush=True)
        runs.append(dict(run, src=str(src), rows=rows[0]))
    cli.json.parent.mkdir(parents=True, exist_ok=True)
    cli.json.write_text(json.dumps({"card": card, "dtype": cli.dtype,
                                    "runs": runs}, indent=1))
    return rc


if __name__ == "__main__":
    sys.exit(main())
