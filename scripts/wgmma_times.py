#!/usr/bin/env python3
"""Device time of the stride-2 bf16 deconvs of the benchmark's cells, on
one NVIDIA GPU, for one or more ``src`` trees in turns.

    python3 scripts/wgmma_times.py --src A/src [--src B/src ...]
                                   [--calls 20] [--json PATH]

Each tree runs in its own process, the trees in the order given, then
reversed.  A tree times DCGAN's generator deconv1-4 at batch 1,024 and
V-Net's up1-4 at batch 8 (bf16 operands and output, bias and relu as the
models fuse them), each layer's ``deconv_fwd`` over ``--calls`` launches
under ``torch.profiler`` (the device time of its ``igemm`` kernels), with
the staging its wrapper recorded (``gather``, ``halo`` or ``wgmma``), the
useful TFLOP/s (multiply-adds of the (position, tap) pairs whose input and
output lie inside the tensors, as ``bench_dcnn/counts.py`` counts them) and
one cuDNN call of the same layer (channels-last, uncropped).  In a tree
with the wgmma route (``tiling.plan_wgmma``) each layer the route takes is
timed twice more: on the gather (``plan_wgmma`` made to decline) and on
the wgmma route over the uncropped ``I + M - 1`` phase grid
(``tiling.cropped_grid`` made to return it), which tells the crop's rows
apart from the inner loop.  Prints the card's name and power limit and
one JSON line per tree and turn; exits non-zero without a card or when
the profiler records no device time.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def useful_macs(layer, batch: int) -> int:
    """Multiply-adds of the deconv's (input position, tap) pairs whose
    output lies inside the cropped output, times the channels."""
    per_dim = [sum(1 for i in range(n_in) for t in range(k)
                   if 0 <= i * s + t - lo < n_out)
               for n_in, n_out, k, s, (lo, _) in zip(
                   layer.in_spatial, layer.out_spatial, layer.kernel,
                   layer.stride, layer.padding)]
    return batch * math.prod(per_dim) * layer.cin * layer.cout // layer.groups


def child(src: Path, calls: int) -> int:
    sys.path.insert(0, str(src))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core import tiling
    from repro_torch.core.engine import UniformEngine
    from repro_torch.kernels.deconv import kernel as dk
    from repro_torch.kernels.deconv import ops as dops
    from repro_torch.kernels.deconv import ref as dref
    from repro_torch.launch import steps as ST

    F = torch.nn.functional
    dev = torch.device("cuda")
    engine = UniformEngine(device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    cells = [("dcgan", l, 1024) for l in
             ST.train_graphs(get_config("dcgan"))["gen"].layers
             if l.op == "deconv"]
    cells += [("vnet", l, 8) for l in
              ST.train_graphs(get_config("v-net"))["vnet"].layers
              if l.op == "deconv"]

    def device_ms(fn, match):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        cuda = torch.autograd.DeviceType.CUDA
        us = sum(getattr(e, "device_time_total",
                         getattr(e, "cuda_time_total", 0.0))
                 for e in prof.key_averages()
                 if getattr(e, "device_type", cuda) == cuda
                 and (match is None or match in e.key))
        return us / 1e3 / calls

    def staged(fn):
        before = dict(getattr(dk, "staging_launches", {}))
        fn()
        torch.cuda.synchronize()
        got = [k[3] for k, n in getattr(dk, "staging_launches", {}).items()
               if n != before.get(k, 0)]
        return got[0] if len(got) == 1 else "gather"

    has_route = hasattr(tiling, "plan_wgmma")
    rows = []
    for model, layer, batch in cells:
        x = torch.randn((batch, *layer.in_spatial, layer.cin), generator=gen,
                        device=dev).to(torch.bfloat16)
        w = (torch.randn(layer.weight_shape, generator=gen, device=dev)
             / math.sqrt(math.prod(layer.weight_shape[:-1]))).to(
                 torch.bfloat16)
        bias = torch.zeros(layer.cout, device=dev)
        x3, wk, kw, _ = dops.deconv_kernel_args(
            x, w, layer.stride, layer.padding, dilation=layer.dilation,
            groups=layer.groups, engine=engine)
        kw = dict(kw, bias=bias, activation="relu")
        fn = lambda: dk.deconv_fwd(x3, wk, **kw)       # noqa: E731
        macs = useful_macs(layer, batch)
        row = {"model": model, "layer": layer.name, "batch": batch,
               "staging": staged(fn), "ms": device_ms(fn, "igemm")}
        r = layer.rank
        fmt = torch.channels_last if r == 2 else torch.channels_last_3d
        xl = x.permute(0, r + 1, *range(1, r + 1))
        wl = w.permute(r, r + 1, *range(r)).contiguous(memory_format=fmt)
        conv_t = F.conv_transpose2d if r == 2 else F.conv_transpose3d
        row["cudnn_ms"] = device_ms(
            lambda: conv_t(xl, wl, stride=layer.stride), None)
        if has_route and row["staging"] == "wgmma":
            real_plan, real_grid = tiling.plan_wgmma, tiling.cropped_grid
            try:
                tiling.plan_wgmma = lambda *a, **k: None
                row["gather_ms"] = device_ms(fn, "igemm")
                row["gather_staging"] = staged(fn)
                tiling.plan_wgmma = real_plan
                q = dref.phase_rows(tuple(x3.shape[1:4]), kw["kernel"],
                                    kw["stride"], kw["dilation"],
                                    kw["crop_lo"], kw["out_spatial"])
                tiling.cropped_grid = lambda *a: ((0, 0, 0), tuple(q))
                real_plan.cache_clear()
                row["uncropped_ms"] = device_ms(fn, "igemm")
                row["uncropped_grid"] = list(dk.planned_wgmma(x3, wk,
                                                              **kw).grid)
            finally:
                tiling.plan_wgmma, tiling.cropped_grid = real_plan, real_grid
                real_plan.cache_clear()
        for key in ("ms", "gather_ms", "uncropped_ms"):
            if key in row:
                row[key.replace("ms", "tflops")] = 2 * macs / row[key] / 1e9
        rows.append(row)
        del x, w, x3, wk
    torch.cuda.empty_cache()
    print(json.dumps({"rows": rows}))
    return 0 if all(r["ms"] > 0 for r in rows) else 1


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--src", type=Path, action="append", default=[])
    parser.add_argument("--calls", type=int, default=20)
    parser.add_argument("--json", type=Path, default=None)
    parser.add_argument("--child", type=Path, default=None,
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child is not None:
        return child(args.child, args.calls)
    if not args.src:
        parser.error("name at least one --src tree")
    import torch
    if not torch.cuda.is_available():
        print("wgmma_times: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         text=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    out, rc = [], 0
    for turn, src in enumerate(args.src + args.src[::-1]):
        proc = subprocess.run(
            [sys.executable, __file__, "--child", str(src.resolve()),
             "--calls", str(args.calls)], stdout=subprocess.PIPE, text=True)
        rc |= proc.returncode
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        res = json.loads(lines[-1]) if lines else {"rows": []}
        res.update(src=str(src), turn=turn)
        out.append(res)
        print(json.dumps(res), flush=True)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"card": smi, "runs": out}, indent=1))
    return rc


if __name__ == "__main__":
    sys.exit(main())
