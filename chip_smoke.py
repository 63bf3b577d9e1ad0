#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--json PATH]

Phases, any failure of which exits non-zero before the result line:

  1. device — require CUDA, print versions and the card's name and power
     limit, force IEEE f32 (TF32 off) in cuBLAS and cuDNN;
  2. build — compile both CUDA kernels from ``src/repro_torch/csrc``;
  3. kernels against their plain versions — every distinct layer geometry
     of full-width DCGAN and V-Net at the served batch, in f32 and bf16,
     plus groups, dilation, rank 1, K=5/S=1 and scale+leaky_relu cases;
  4. serve — a ``DcnnServer`` answers 8 DCGAN seeds and 4 V-Net volumes at
     full width through the kernels (launch counts checked per batch), and
     one request of each model is held against the port's CPU run;
  5. times — each kernel at each main-path layer shape (CUDA events) beside
     its plain version, one cuDNN call computing the same function, and
     the bound; then one served batch of each model end to end.

The line before the last is the ``{"kernels": [...]}`` summary and the last
line is ``{"ok": true, "device": {...}}``.  ``--json PATH`` also writes
every check and per-layer time to PATH.
"""

from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense): IEEE f32 on CUDA cores, bf16 tensor
# cores, HBM3 bandwidth
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
# kernel vs plain version, max|diff| / max|plain|: f32 sums in another
# order (1e-4, the reference's tolerance); bf16 output may differ by one
# bf16 rounding step (2^-8 relative), so 1e-2
TOL = {"float32": 1e-4, "bfloat16": 1e-2}
SERVE_TOL = 1e-4                 # card vs CPU run of the port, f32

DCGAN_CHANS = (1024, 512, 256, 128, 3)
VNET_CHANS = (16, 32, 64, 128, 256)
VNET_SPATIAL = (128, 128, 64)
BATCH = 4                        # the server's max_batch


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def main() -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--json", type=Path, default=None,
                        help="write every check and time to this file")
    cli = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.core import networks as nets
    from repro_torch.core.engine import (
        UniformEngine,
        compile_network,
    )
    from repro_torch.kernels import build
    from repro_torch.kernels.conv import kernel as ck
    from repro_torch.kernels.conv import ops as cops
    from repro_torch.kernels.conv import ref as cref
    from repro_torch.kernels.deconv import kernel as dk
    from repro_torch.kernels.deconv import ops as dops
    from repro_torch.kernels.deconv import ref as dref
    from repro_torch.runtime.dcnn_server import (
        DcnnServer,
        ServeRequest,
        dcgan_gen_spec,
        pad_to,
        vnet_spec,
    )

    detail: dict = {}
    # -- 1. device ----------------------------------------------------------
    phase("device")
    name = torch.cuda.get_device_name(0)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {name}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    detail["card"] = smi
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    engine = UniformEngine(device=dev)

    # -- 2. build -----------------------------------------------------------
    phase("build")
    t0 = time.perf_counter()
    _, log = build.build()
    build.library()
    detail["build_s"] = time.perf_counter() - t0
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill stores",
                                             log))
    detail["ptxas"] = {"kernels": len(regs), "max_registers": max(regs,
                                                                  default=0),
                       "spill_store_bytes": spills}
    print(f"build_s {detail['build_s']:.1f} ptxas {detail['ptxas']}")

    # -- helpers --------------------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(shape, dtype, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(
            dtype)

    # op -> (main-path wrapper arguments, kernel wrapper, plain version)
    KERNELS = {"deconv": (dops.deconv_kernel_args, dk.deconv_fwd,
                          dref.deconv_fwd_plain),
               "conv": (cops.conv_kernel_args, ck.conv_fwd,
                        cref.conv_fwd_plain)}

    def operands(op, in_spatial, cin, w_shape, dtype, stride, padding,
                 dilation=1, groups=1, bias=True, scale=False,
                 activation="none", alpha=0.2, batch=BATCH):
        """Random main-path operands -> (x, w, b, s, wrapper args)."""
        x = rand((batch, *in_spatial, cin), dtype)
        fan_in = math.prod(w_shape[:-1])
        w = rand(w_shape, dtype, 1.0 / math.sqrt(fan_in))
        b = rand((w_shape[-1],), dtype, 0.1) if bias else None
        s = (rand((w_shape[-1],), torch.float32).abs() + 0.5) if scale \
            else None
        args = KERNELS[op][0](x, w, stride, padding, dilation=dilation,
                              groups=groups, bias=b, w_scale=s,
                              activation=activation, alpha=alpha,
                              engine=engine)
        return x, w, b, args

    def layer_operands(layer, dtype, batch=BATCH):
        epi = layer.epilogue
        return operands(layer.op, layer.in_spatial, layer.cin,
                        layer.weight_shape, dtype, layer.stride,
                        layer.padding, layer.dilation, layer.groups,
                        bias=epi.bias, activation=epi.activation,
                        alpha=epi.alpha, batch=batch)

    def run_kernel(op, args):
        x3, wk, kw, _ = args
        return KERNELS[op][1](x3, wk, **kw)

    def run_plain(op, args):
        x3, wk, kw, _ = args
        kw = {k: v for k, v in kw.items() if k != "block_co"}
        return KERNELS[op][2](x3, wk, **kw)

    dcgan_layers = dcgan_gen_spec(chans=DCGAN_CHANS).graph_for(None).layers
    vnet_layers = nets.vnet_graph(in_spatial=VNET_SPATIAL,
                                  chans=VNET_CHANS).layers
    main_layers = [("dcgan", l) for l in dcgan_layers] + \
        [("vnet", l) for l in vnet_layers]

    # -- 3. kernels against their plain versions ------------------------------
    phase("kernels vs plain versions")
    max_abs = {"deconv": 0.0, "conv": 0.0}
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for model, layer in main_layers:
            cases.append((f"{model}:{layer.name}", layer.op, dtype,
                          lambda l=layer, d=dtype: layer_operands(l, d)))
        extra = [
            ("groups2+dil2+scale+leaky", "deconv", (6, 7, 5), 16,
             (3, 3, 3, 8, 24), 2, 1, 2, 2),
            ("groups2+dil2+scale+leaky", "conv", (9, 7, 8), 16,
             (3, 3, 3, 8, 24), 2, 1, 2, 2),
            ("rank1", "deconv", (50,), 12, (5, 12, 20), 3, ((1, 2),), 1, 1),
            ("rank1", "conv", (50,), 12, (5, 12, 20), 2, 2, 1, 1),
            ("k5s1", "deconv", (12, 12, 12), 16, (5, 5, 5, 16, 32), 1, 2,
             1, 1),
            ("k5s1", "conv", (12, 12, 12), 16, (5, 5, 5, 16, 32), 1, 2, 1,
             1),
        ]
        for tag, op, sp, cin, ws, st, pad, dil, g in extra:
            cases.append((tag, op, dtype, lambda op=op, sp=sp, cin=cin,
                          ws=ws, st=st, pad=pad, dil=dil, g=g, d=dtype:
                          operands(op, sp, cin, ws, d, st, pad, dil, g,
                                   scale=True, activation="leaky_relu",
                                   alpha=0.1, batch=2)))
    detail["checks"] = []
    for tag, op, dtype, make in cases:
        _, _, _, args = make()
        got = run_kernel(op, args)
        torch.cuda.synchronize()
        ref = run_plain(op, args)
        err = float((got.float() - ref.float()).abs().max())
        mag = float(ref.float().abs().max())
        dname = str(dtype).split(".")[-1]
        rel = err / mag if mag else err
        print(json.dumps({"check": tag, "op": op, "dtype": dname,
                          "shape": list(got.shape), "max_abs_err": err,
                          "rel_err": rel, "tol": TOL[dname]}))
        detail["checks"].append({"check": tag, "op": op, "dtype": dname,
                                 "max_abs_err": err, "rel_err": rel})
        check(got.shape == ref.shape and got.dtype == ref.dtype,
              f"{tag}/{op}/{dname}: kernel output {got.shape} {got.dtype} "
              f"vs plain {ref.shape} {ref.dtype}")
        check(rel <= TOL[dname], f"{tag}/{op}/{dname}: relative error "
              f"{rel:.3g} above {TOL[dname]}")
        max_abs[op] = max(max_abs[op], err)
        del got, ref, args
    torch.cuda.empty_cache()

    # -- 4. serve -------------------------------------------------------------
    phase("serve")
    gen_spec = dcgan_gen_spec(chans=DCGAN_CHANS)
    vol_spec = vnet_spec(chans=VNET_CHANS, base_spatial=VNET_SPATIAL)
    server = DcnnServer([gen_spec, vol_spec], max_batch=BATCH)
    rng = np.random.default_rng(0)
    seeds = [rng.standard_normal((4, 4, DCGAN_CHANS[0]), dtype=np.float32)
             for _ in range(8)]
    vols = [rng.standard_normal((*VNET_SPATIAL, 1), dtype=np.float32)
            for _ in range(3)]
    vols.append(rng.standard_normal((120, 124, 60, 1), dtype=np.float32))
    reqs = [ServeRequest("dcgan_gen", x) for x in seeds] + \
        [ServeRequest("vnet", x) for x in vols]
    for r in reqs:
        server.submit(r)
    dk.launches = ck.launches = 0           # the main path's run starts
    results, steps = [], []
    t_serve = time.perf_counter()
    while server.queue.depth:
        before = (dk.launches, ck.launches)
        got = server.step()
        delta = (dk.launches - before[0], ck.launches - before[1])
        models = {r.model for r in got}
        steps.append({"models": sorted(models), "requests": len(got),
                      "deconv_launches": delta[0],
                      "conv_launches": delta[1]})
        print(json.dumps({"served_batch": steps[-1]}))
        check(len(models) == 1, f"one batch served {models}")
        want = (4, 0) if models == {"dcgan_gen"} else (4, 10)
        check(delta == want, f"{models} batch launched (deconv, conv) = "
              f"{delta}, expected {want}")
        results.extend(got)
    serve_s = time.perf_counter() - t_serve
    launches = {"deconv": dk.launches, "conv": ck.launches}
    print(json.dumps({"main_path_launches": launches,
                      "serve_s": serve_s}))
    check(launches == {"deconv": 12, "conv": 10},
          f"main path launches {launches}")
    by_id = {r.id: r for r in results}
    check(sorted(by_id) == [r.id for r in reqs], "a request went missing")
    for r in reqs:
        res = by_id[r.id]
        want = ((64, 64, 3) if r.model == "dcgan_gen"
                else (*r.x.shape[:-1], 2))
        check(res.ok, f"request {r.id} failed: {res.error!r}")
        check(res.output.shape == want,
              f"request {r.id} shape {res.output.shape} != {want}")
        check(bool(np.isfinite(res.output).all()),
              f"request {r.id} output not finite")

    # the same graph, weights and input on the CPU (plain versions)
    torch.set_num_threads(os.cpu_count() or 1)
    cpu = UniformEngine(device="cpu")
    detail["cpu_parity"] = {}
    for req in (reqs[0], reqs[-1]):
        spec = server.specs[req.model]
        bsp = spec.bucket_spatial(tuple(req.x.shape[:-1]))
        apply, _ = compile_network(spec.graph_for(bsp), cpu)
        t0 = time.perf_counter()
        with torch.inference_mode():
            ref = apply(spec.weights,
                        torch.from_numpy(pad_to(req.x, bsp))[None])[0]
        ref = ref.numpy()[tuple(slice(0, d)
                                for d in by_id[req.id].output.shape)]
        err = float(np.abs(by_id[req.id].output - ref).max())
        rel = err / float(np.abs(ref).max())
        detail["cpu_parity"][req.model] = {"max_abs_err": err,
                                           "rel_err": rel,
                                           "cpu_s": time.perf_counter() - t0}
        print(json.dumps({"cpu_parity": req.model, "bucket": list(bsp),
                          "max_abs_err": err, "rel_err": rel,
                          "tol": SERVE_TOL}))
        check(rel <= SERVE_TOL, f"{req.model}: card vs CPU relative error "
              f"{rel:.3g} above {SERVE_TOL}")

    # -- 5. times -------------------------------------------------------------
    phase("times")
    print(json.dumps({"bound_peaks": {
        "float32_flops": PEAK_FLOPS["float32"],
        "bfloat16_flops": PEAK_FLOPS["bfloat16"], "hbm_bytes_per_s":
        PEAK_BYTES, "source": "H100 SXM data sheet, dense; f32 on CUDA "
        "cores"}}))

    def per_call_ms(fn, calls, groups=5):
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

    def library_call(layer, x, w, b):
        """One cuDNN call computing the same conv/deconv (+bias; the
        activation is a separate op there), channels-last, layouts
        permuted outside the timed region."""
        r = layer.rank
        fmt = torch.channels_last if r == 2 else torch.channels_last_3d
        xl = x.permute(0, r + 1, *range(1, r + 1))
        if layer.op == "deconv":
            wl = w.permute(r, r + 1, *range(r)).contiguous(
                memory_format=fmt)
            fn = F.conv_transpose2d if r == 2 else F.conv_transpose3d
            return lambda: fn(xl, wl, b, stride=layer.stride,
                              dilation=layer.dilation)
        wl = w.permute(r + 1, r, *range(r)).contiguous(memory_format=fmt)
        fn = F.conv2d if r == 2 else F.conv3d
        pad = tuple(lo for lo, _ in layer.padding)
        check(all(lo == hi for lo, hi in layer.padding), "symmetric pad")
        return lambda: fn(xl, wl, b, stride=layer.stride, padding=pad,
                          dilation=layer.dilation)

    totals = {op: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                   "library_ms": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0}
              for op in KERNELS}
    detail["layers"] = []
    for model, layer in main_layers:
        x, w, b, args = layer_operands(layer, torch.float32)
        y = run_kernel(layer.op, args)
        kms = per_call_ms(lambda: run_kernel(layer.op, args), 10)
        pms = per_call_ms(lambda: run_plain(layer.op, args), 2, groups=3)
        lms = per_call_ms(library_call(layer, x, w, b), 10)
        nbytes = sum(t.numel() * t.element_size()
                     for t in (x, w, y) + ((b,) if b is not None else ()))
        flops = 2 * BATCH * layer.valid_macs
        ops_ms = 1e3 * flops / PEAK_FLOPS["float32"]
        bytes_ms = 1e3 * nbytes / PEAK_BYTES
        row = {"layer": f"{model}:{layer.name}", "op": layer.op,
               "batch": BATCH, "in": list(x.shape), "out": list(y.shape),
               "launches_per_batch": 1, "ms": kms, "plain_ms": pms,
               "library_ms": lms, "bound_ms": max(ops_ms, bytes_ms),
               "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
               "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
               "tflops": flops / kms / 1e9}
        print(json.dumps(row))
        detail["layers"].append(row)
        tot = totals[layer.op]
        tot["ms"] += kms
        tot["plain_ms"] += pms
        tot["library_ms"] += lms
        tot["bound_ms"] += row["bound_ms"]
        tot["ops_ms" if ops_ms >= bytes_ms else "bytes_ms"] += \
            row["bound_ms"]
        del x, w, b, args, y
    torch.cuda.empty_cache()

    detail["e2e"] = {}
    for model, xs in (("dcgan_gen", seeds[:BATCH]), ("vnet", vols)):
        lat = []
        for _ in range(3):
            for x in xs:
                server.submit(ServeRequest(model, x))
            t0 = time.perf_counter()
            got = server.step()
            lat.append(time.perf_counter() - t0)
            check(len(got) == len(xs) and all(r.ok for r in got),
                  f"{model} timing batch failed")
        detail["e2e"][model] = {"batch": len(xs), "seconds": lat}
        print(json.dumps({"e2e_batch": model, "batch": len(xs),
                          "seconds": lat,
                          "median_ms": 1e3 * statistics.median(lat)}))

    summary = {"kernels": [
        {"name": "deconv_fwd", "route": "cuda",
         "source": "src/repro_torch/csrc/deconv_fwd.cu",
         "replaces": "src/repro/kernels/deconv/kernel.py:180",
         "launches": launches["deconv"],
         "max_abs_err": max_abs["deconv"]},
        {"name": "conv_fwd", "route": "cuda",
         "source": "src/repro_torch/csrc/conv_fwd.cu",
         "replaces": "src/repro/kernels/conv/kernel.py:146",
         "launches": launches["conv"],
         "max_abs_err": max_abs["conv"]},
    ]}
    for entry, op in zip(summary["kernels"], ("deconv", "conv")):
        tot = totals[op]
        entry.update(ms=tot["ms"], plain_ms=tot["plain_ms"],
                     bound_ms=tot["bound_ms"],
                     bound_by=("operations" if tot["ops_ms"] >= tot["bytes_ms"]
                               else "bytes"),
                     library_ms=tot["library_ms"])
    detail["summary"] = summary
    if cli.json is not None:
        cli.json.parent.mkdir(parents=True, exist_ok=True)
        cli.json.write_text(json.dumps(detail, indent=1))
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
