#!/usr/bin/env python3
"""Where the halo-staged bf16 kernel's time goes, on one NVIDIA GPU.

    python3 scripts/halo_levers.py [--json PATH]

Builds variants of the forward kernels from edited copies of
``src/repro_torch/csrc`` under ``build/halo_levers/<variant>/`` (one
library each: the two forward sources' twelve parts and the wgmma
staging's object), each with one part of ``igemm_bf16_halo_kernel``'s
work removed: its k16 steps (``no_mma``), A's or B's copies
(``no_afill``, ``no_bfill``), the epilogue's stores (``no_store``), the
slot table's setup (``no_setup``); the results of
those are wrong, only their time counts.  Each variant runs in its own
process (one library a process) and times, under ``torch.profiler``, the
device time of the halo-staged launches of V-Net merge4, merge3, merge2
(bf16, batch 4) and merge4's dx, 20 launches each; ``base`` runs first
and last.  Prints the card's name and power limit and one JSON line per
variant.  Exits non-zero without a card or ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "halo_levers"
SOURCES = ("conv_fwd", "deconv_fwd")
CALLS = 20

# variant -> (text of igemm.cuh, its replacement)
EDITS = {
    "base": [],
    "no_mma": [("    for (int ks = 0; ks < steps; ++ks) {",
                "    for (int ks = 0; ks < 0; ++ks) {")],
    "no_afill": [("      if (pos == HALO_SLOT_NONE) continue;",
                  "      if (pos != 12345) continue;")],
    "no_bfill": [("    for (int e = tid; e < copies; e += THREADS) {",
                  "    for (int e = tid; e < 0; e += THREADS) {")],
    "no_store": [("  store_box_tile<TL>(ctile, rowoff, g, b, ep, y, out_bf16);",
                  "  if (threadIdx.x == 0 && ctile[5] == 1.2345f)\n"
                  "    static_cast<float*>(y)[0] = 0.f;")],
    "no_setup": [("    for (int i = tid; i < h.slots; i += THREADS) {\n"
                  "      int v = HALO_SLOT_ZERO;",
                  "    for (int i = tid; i < h.slots; i += THREADS) {\n"
                  "      slotpos[i] = i;\n      continue;\n"
                  "      int v = HALO_SLOT_ZERO;")],
}
# (tag, op, spatial, cin, weight shape, batch)
LAYERS = (("merge4", "conv", (128, 128, 64), 32, (3, 3, 3, 32, 16), 4),
          ("merge3", "conv", (64, 64, 32), 64, (3, 3, 3, 64, 32), 4),
          ("merge2", "conv", (32, 32, 16), 128, (3, 3, 3, 128, 64), 4),
          ("merge4_dx", "deconv", (128, 128, 64), 16, (3, 3, 3, 16, 32), 4))


def build_variants(nvcc: str, flags) -> None:
    """Every variant's library, all objects compiled together."""
    procs = []
    for name, edits in EDITS.items():
        d = OUT / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        text = (CSRC / "igemm.cuh").read_text()
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{name}: the kernel source changed")
            text = text.replace(old, new)
        (d / "igemm.cuh").write_text(text)
        for src in SOURCES:
            shutil.copy(CSRC / f"{src}.cu", d / f"{src}.cu")
            for k in range(12):
                procs.append((name, subprocess.Popen(
                    [nvcc, *flags, f"-DREPRO_PART={k}", "-c",
                     str(d / f"{src}.cu"), "-o", str(d / f"{src}_{k}.o")],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        # the forward entry calls the wgmma staging's object
        shutil.copy(CSRC / "deconv_wgmma.cu", d / "deconv_wgmma.cu")
        procs.append((name, subprocess.Popen(
            [nvcc, *flags, "-c", str(d / "deconv_wgmma.cu"), "-o",
             str(d / "deconv_wgmma.o")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    for name, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{out.decode()[-3000:]}")
    for name in EDITS:
        d = OUT / name
        subprocess.run([nvcc, "-shared", "-o", str(d / "lib.so"),
                        *(str(d / f"{src}_{k}.o") for src in SOURCES
                          for k in range(12)), str(d / "deconv_wgmma.o")],
                       check=True)


def child(name: str) -> int:
    """Time the layers on variant ``name``'s library; one JSON line."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.engine import UniformEngine
    from repro_torch.kernels import build
    from repro_torch.kernels.conv import kernel as ck
    from repro_torch.kernels.conv import ops as cops
    from repro_torch.kernels.deconv import kernel as dk
    from repro_torch.kernels.deconv import ops as dops

    lib = ctypes.CDLL(str(OUT / name / "lib.so"))
    ints = ctypes.POINTER(ctypes.c_int)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.repro_conv_fwd.argtypes = [P, P, P, P, P, P, ints, I,
                                   ctypes.c_float, I, I, I, I, I, ints,
                                   ints, P]
    lib.repro_deconv_fwd.argtypes = [P, P, P, P, P, P, P, ints, I,
                                     ctypes.c_float, I, I, I, I, I, ints,
                                     ints, ints, P]
    lib.repro_conv_fwd.restype = lib.repro_deconv_fwd.restype = I
    build.library = lambda: lib

    def stagings():
        """Both forward wrappers' launches so far, by staging."""
        out = {}
        for mod in (ck, dk):
            for key, n in mod.staging_launches.items():
                out[key[-1]] = out.get(key[-1], 0) + n
        return out

    dev = torch.device("cuda")
    engine = UniformEngine(device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    row = {"variant": name}
    for tag, op, sp, cin, ws, batch in LAYERS:
        x = torch.randn((batch, *sp, cin), generator=gen,
                        device=dev).to(torch.bfloat16)
        w = (torch.randn(ws, generator=gen, device=dev)
             / math.sqrt(math.prod(ws[:-1]))).to(torch.bfloat16)
        args = cops.conv_kernel_args if op == "conv" \
            else dops.deconv_kernel_args
        x3, wk, kw, _ = args(x, w, 1, 1, activation="relu", engine=engine)
        fn = ((lambda: ck.conv_fwd(x3, wk, **kw)) if op == "conv" else
              (lambda: dk.deconv_fwd(x3, wk, **kw)))
        before = stagings()
        fn()
        torch.cuda.synchronize()
        after = stagings()
        staged = {k for k in after if after[k] != before.get(k, 0)}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "device_time_total", 0.0)
                 for e in prof.key_averages() if "igemm" in e.key)
        row[tag] = {"device_ms": us / 1e3 / CALLS, "staging": sorted(staged)}
        del x, w, x3, wk
    print(json.dumps(row), flush=True)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--json", type=Path,
                        default=ROOT / "build" / "halo_levers.json")
    parser.add_argument("--child", default=None, help=argparse.SUPPRESS)
    cli = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("halo_levers: no CUDA device", file=sys.stderr)
        return 2
    if cli.child is not None:
        return child(cli.child)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    t0 = time.perf_counter()
    build_variants(build._nvcc(), build.NVCC_FLAGS)
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    rows, rc = [], 0
    for name in [*EDITS, "base"]:
        proc = subprocess.run([sys.executable, __file__, "--child", name],
                              capture_output=True, text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        if proc.returncode or not lines:
            print(f"== {name} rc {proc.returncode}\n{proc.stderr[-3000:]}")
            rc = 1
            continue
        print(lines[-1], flush=True)
        rows.append(json.loads(lines[-1]))
    cli.json.parent.mkdir(parents=True, exist_ok=True)
    cli.json.write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    return rc


if __name__ == "__main__":
    sys.exit(main())
