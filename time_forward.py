#!/usr/bin/env python3
"""Time the forward kernels of one served batch on one NVIDIA GPU.

    python3 time_forward.py [--src DIR] [--dtype bfloat16] [--weights int8]
                            [--json PATH]

Every conv and deconv layer of a served DCGAN generator batch and a
served V-Net batch (full width, batch 4, weights and inputs random from
a seed) is launched through the port's kernel wrappers in one operand
type (``--dtype``: float32 or bfloat16), the weights in that type too or,
with ``--weights int8``, quantized per output channel (int8 weights
beside the activations, the scale in the epilogue), and timed with CUDA
events, the median of five groups of ten launches.  ``--src`` names the ``src``
directory whose ``repro_torch`` is timed (default: this checkout's), so
one copy of this script times two commits in turns.  Prints the card's
name and power limit, one JSON line per layer and, last, the sums per
model.  Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

DCGAN_CHANS = (1024, 512, 256, 128, 3)
VNET_CHANS = (16, 32, 64, 128, 256)
VNET_SPATIAL = (128, 128, 64)
BATCH = 4


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--src", type=Path,
                        default=Path(__file__).resolve().parent / "src")
    parser.add_argument("--dtype", default="bfloat16",
                        choices=("float32", "bfloat16"))
    parser.add_argument("--weights", default="same", choices=("same", "int8"))
    parser.add_argument("--json", type=Path, default=None)
    cli = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_forward: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(cli.src.resolve()))
    from repro_torch.core import networks as nets
    from repro_torch import quant
    from repro_torch.core.engine import UniformEngine
    from repro_torch.kernels.conv import kernel as ck
    from repro_torch.kernels.conv import ops as cops
    from repro_torch.kernels.deconv import kernel as dk
    from repro_torch.kernels.deconv import ops as dops
    from repro_torch.runtime.dcnn_server import dcgan_gen_spec

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    dtype = getattr(torch, cli.dtype)
    engine = UniformEngine(device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    ops = {"deconv": (dops.deconv_kernel_args, dk.deconv_fwd),
           "conv": (cops.conv_kernel_args, ck.conv_fwd)}

    def per_call_ms(fn, calls=10, groups=5):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(groups):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(calls):
                fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b) / calls)
        return statistics.median(ts)

    models = {
        "dcgan": dcgan_gen_spec(chans=DCGAN_CHANS).graph_for(None).layers,
        "vnet": nets.vnet_graph(in_spatial=VNET_SPATIAL,
                                chans=VNET_CHANS).layers}
    rows, sums = [], {}
    for model, layers in models.items():
        for layer in layers:
            x = torch.randn((BATCH, *layer.in_spatial, layer.cin),
                            generator=gen, device=dev).to(dtype)
            w = (torch.randn(layer.weight_shape, generator=gen, device=dev)
                 / math.sqrt(math.prod(layer.weight_shape[:-1])))
            scale = None
            if cli.weights == "int8":
                q = quant.quantize_tensor(w)
                w, scale = q["w_q"], q["scale"]
            else:
                w = w.to(dtype)
            epi = layer.epilogue
            b = (0.1 * torch.randn((layer.cout,), generator=gen,
                                   device=dev)).to(dtype) if epi.bias else None
            args_fn, kernel = ops[layer.op]
            x3, wk, kw, _ = args_fn(
                x, w, layer.stride, layer.padding, dilation=layer.dilation,
                groups=layer.groups, bias=b, w_scale=scale,
                activation=epi.activation, alpha=epi.alpha, engine=engine)
            ms = per_call_ms(lambda: kernel(x3, wk, **kw))
            row = {"model": model, "layer": layer.name, "op": layer.op,
                   "dtype": cli.dtype, "weights": cli.weights, "ms": ms}
            print(json.dumps(row), flush=True)
            rows.append(row)
            sums[model] = sums.get(model, 0.0) + ms
            del x, w, b, x3, wk
        torch.cuda.empty_cache()
    out = {"card": card, "src": str(cli.src), "dtype": cli.dtype,
           "weights": cli.weights, "batch": BATCH, "sum_ms": sums,
           "layers": rows}
    if cli.json is not None:
        cli.json.parent.mkdir(parents=True, exist_ok=True)
        cli.json.write_text(json.dumps(out, indent=1))
    print(json.dumps({"sum_ms": sums, "dtype": cli.dtype,
                      "weights": cli.weights}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
