#!/usr/bin/env python3
"""Time the bf16 route's two gather levers on one NVIDIA GPU.

    python3 scripts/bf16_levers.py [--parent DIR/src] [--json PATH]

The bf16 x bf16 forward kernel (``csrc/igemm.cuh::igemm_bf16_kernel``)
is built in four variants, each from a copy of this checkout's
``src/repro_torch`` under ``build/bf16_levers/<variant>/`` with only its
tiles and A's copy flavour edited (the planner's ``BF16_KERNEL_TILES``
edited to match):

  * ``kb64``: 64 bytes (32 pairs) of each row a stage, the tiles as
    committed; ``kb128``: 128 bytes (64 pairs) a stage, two stages per
    tile, the blocks an SM keeps resident as the shared memory allows;
  * ``cg``: A's 16-byte copies skip L1; ``ca``: they allocate in L1.

Each variant first builds (its ``-Xptxas -v`` lines for the bf16 route's
kernels kept: registers, spill stores) and runs the bf16 x bf16 checks
of ``chip_smoke.py``'s forward kernel paths phase with f32 output against
float64 of the same operands (reduction depths 864, 3,456 and 4,096,
unsplit and split, each launch twice for the same bits); then
``time_forward.py --dtype bfloat16`` times every layer of a served V-Net
and DCGAN batch on each variant in turns (the variants in order, then in
reverse), each run in its own process.  ``--parent`` adds another
``src`` tree (a parent commit's) to the turns.  Prints the card's name
and power limit, one JSON line per check and per timed run and, last, the
summary: per variant the V-Net merge4 and DCGAN layer times of every
turn, the models' sums and the checks' worst error.  Exits non-zero
without a card or when a check fails.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "bf16_levers"
# (block_m, block_co, warps_m, warps_n, stages, min_blocks, k_bytes) per
# tile: 64 bytes a stage as committed, or 128 bytes in two stages
KB128_TILES = ((256, 16, 8, 1, 2, 2, 128), (256, 32, 8, 1, 2, 2, 128),
               (128, 64, 4, 2, 2, 2, 128), (128, 128, 4, 4, 2, 1, 128))
VARIANTS = {"kb64-cg": (None, False), "kb64-ca": (None, True),
            "kb128-cg": (KB128_TILES, False),
            "kb128-ca": (KB128_TILES, True)}
# chip_smoke.py's bf16 x bf16 f32-output cases: (tag, op, in_spatial, cin,
# w_shape, stride, padding, batch, slices forced (None: the planner's))
DEEP_CASES = (
    ("d864:unsplit", "conv", (13, 11, 9), 32, (3, 3, 3, 32, 32), 1, 1, 2,
     1),
    ("d864:split", "conv", (13, 11, 9), 32, (3, 3, 3, 32, 32), 1, 1, 2, 3),
    ("d3456:unsplit", "conv", (16, 16, 8), 128, (3, 3, 3, 128, 256), 2, 1,
     4, 1),
    ("d3456:planner", "conv", (16, 16, 8), 128, (3, 3, 3, 128, 256), 2, 1,
     4, None),
    ("d4096:unsplit", "deconv", (4, 4), 1024, (3, 3, 1024, 512), 2,
     ((0, 1),) * 2, 4, 1),
    ("d4096:planner", "deconv", (4, 4), 1024, (3, 3, 1024, 512), 2,
     ((0, 1),) * 2, 4, None),
)
W8_TOL = 5e-5


def _sub_once(pattern: str, repl: str, text: str) -> str:
    out, n = re.subn(pattern, repl, text, flags=re.S)
    if n != 1:
        raise RuntimeError(f"{pattern!r} matched {n} times")
    return out


def make_tree(name: str) -> Path:
    """This checkout's ``src/repro_torch`` copied under ``OUT / name`` with
    the variant's tiles and A copy flavour; returns its ``src``."""
    tiles, l1 = VARIANTS[name]
    src = OUT / name / "src"
    shutil.rmtree(OUT / name, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", src / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cuh = src / "repro_torch" / "csrc" / "igemm.cuh"
    text = _sub_once(r"constexpr bool BF16_A_L1 = \w+;",
                     f"constexpr bool BF16_A_L1 = {str(l1).lower()};",
                     cuh.read_text())
    if tiles is not None:
        for t in tiles:
            text = _sub_once(rf"using Bf16Tile{t[1]} = MmaTile<[^>]*>;",
                             f"using Bf16Tile{t[1]} = MmaTile<"
                             f"{', '.join(map(str, t))}>;", text)
        py = src / "repro_torch" / "core" / "tiling.py"
        rows = ",\n".join(
            f"    MmaKernelTile({bm}, {bn}, {wm}, {wn}, {kb}, {st}, {mb})"
            for bm, bn, wm, wn, st, mb, kb in tiles)
        py.write_text(_sub_once(
            r"BF16_KERNEL_TILES = \{t\.block_co: t for t in \(.*?\)\}",
            f"BF16_KERNEL_TILES = {{t.block_co: t for t in (\n{rows})}}",
            py.read_text()))
    cuh.write_text(text)
    return src


def bf16_ptxas(log: str) -> list[dict]:
    """Registers and spill stores of each bf16 route kernel in a build
    log (``build.build``'s)."""
    rows, fn = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        if fn and "igemm_bf16_kernel" in fn:
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                rows.append({"kernel": fn, "spill_stores": int(m.group(1))})
            m = re.search(r"Used (\d+) registers", line)
            if m and rows:
                rows[-1]["registers"] = int(m.group(1))
    return rows


def child_check(src: Path) -> int:
    """Build the tree at ``src``, report its bf16 kernels' ptxas lines and
    run the f32-output checks against float64."""
    sys.path.insert(0, str(src))
    import torch
    from repro_torch.core import tiling
    from repro_torch.core.engine import UniformEngine
    from repro_torch.kernels import build
    from repro_torch.kernels.conv import kernel as ck
    from repro_torch.kernels.conv import ops as cops
    from repro_torch.kernels.conv import ref as cref
    from repro_torch.kernels.deconv import kernel as dk
    from repro_torch.kernels.deconv import ops as dops
    from repro_torch.kernels.deconv import ref as dref

    _, log = build.build()
    build.library()
    ptx = bf16_ptxas(log)
    print(json.dumps({"src": str(src), "bf16_kernels": len(ptx),
                      "max_registers": max((r.get("registers", 0)
                                            for r in ptx), default=0),
                      "spill_stores": sum(r["spill_stores"] for r in ptx)}))
    dev = torch.device("cuda")
    engine = UniformEngine(device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    kernels = {"deconv": (dops.deconv_kernel_args, dk.deconv_fwd,
                          dref.deconv_fwd_plain),
               "conv": (cops.conv_kernel_args, ck.conv_fwd,
                        cref.conv_fwd_plain)}
    real_split, force, slices = tiling.launch_split, [None], []

    def logged(*a, **k):
        out = (force[0] or real_split)(*a, **k)
        slices.append(out[0])
        return out

    tiling.launch_split = logged
    ok = True
    for tag, op, sp, cin, ws, st, pad, batch, n in DEEP_CASES:
        def rand(shape, scale=1.0):
            return (scale * torch.randn(shape, generator=gen, device=dev)
                    ).to(torch.bfloat16)
        x = rand((batch, *sp, cin))
        w = rand(ws, 1.0 / math.sqrt(math.prod(ws[:-1])))
        b = rand((ws[-1],), 0.1)
        s = torch.randn((ws[-1],), generator=gen, device=dev).abs() + 0.5
        x3, wk, kw, _ = kernels[op][0](x, w, st, pad, bias=b, w_scale=s,
                                       activation="leaky_relu", alpha=0.1,
                                       engine=engine)
        kw = dict(kw, out_dtype=torch.float32)
        force[0] = None if n is None else (
            lambda plan, rows, depth, cout, groups, phases=1, n=n:
            tiling.split_reduction(1 << 30, depth, 1) if n == 1 else
            tiling.split_reduction(1, depth, n, phases))
        slices.clear()
        got = kernels[op][1](x3, wk, **kw)
        again = kernels[op][1](x3, wk, **kw)
        torch.cuda.synchronize()
        force[0] = None
        plain = {k: v for k, v in kw.items() if k not in ("block_co",
                                                          "split")}
        ref = kernels[op][2](x3.double(), wk.double(),
                             **dict(plain, out_dtype=torch.float64))
        rel = float((got.double() - ref).abs().max() / ref.abs().max())
        row = {"check": tag, "splits": slices[0], "rel_err": rel,
               "repeat_equal": bool(torch.equal(got, again)),
               "tol": W8_TOL}
        print(json.dumps(row), flush=True)
        ok &= rel <= W8_TOL and row["repeat_equal"]
    return 0 if ok and not any(r["spill_stores"] for r in ptx) else 1


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", type=Path, default=None,
                        help="another src tree timed in the same turns")
    parser.add_argument("--json", type=Path,
                        default=OUT / "bf16_levers.json")
    parser.add_argument("--child-check", type=Path, default=None,
                        help=argparse.SUPPRESS)
    cli = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bf16_levers: no CUDA device", file=sys.stderr)
        return 2
    if cli.child_check is not None:
        return child_check(cli.child_check)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    trees = {name: make_tree(name) for name in VARIANTS}
    if cli.parent is not None:
        trees["parent"] = cli.parent.resolve()
    result = {"card": card, "variants": {}}
    failed = []
    for name, src in trees.items():
        proc = subprocess.run(
            [sys.executable, __file__, "--child-check", str(src)],
            capture_output=True, text=True, timeout=900)
        print(f"== check {name} (rc {proc.returncode})\n{proc.stdout}"
              f"{proc.stderr[-3000:]}", flush=True)
        lines = [json.loads(x) for x in proc.stdout.splitlines()
                 if x.startswith("{")]
        result["variants"][name] = {"check_rc": proc.returncode,
                                    "checks": lines, "runs": []}
        if proc.returncode != 0 and name != "parent":
            failed.append(name)
    order = list(trees)
    for turn in (order, order[::-1]):
        for name in turn:
            turn_no = len(result["variants"][name]["runs"])
            out = OUT / f"time_{name}_{turn_no}.json"
            proc = subprocess.run(
                [sys.executable, str(ROOT / "time_forward.py"), "--src",
                 str(trees[name]), "--dtype", "bfloat16", "--json",
                 str(out)], capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                print(f"== time {name} failed\n{proc.stderr[-3000:]}")
                failed.append(f"time {name}")
                continue
            run = json.loads(out.read_text())
            layers = {r["layer"]: r["ms"] for r in run["layers"]}
            row = {"variant": name, "sum_ms": run["sum_ms"],
                   "merge4_ms": layers["vnet.merge4"],
                   "dcgan_ms": {k: v for k, v in layers.items()
                                if k.startswith("dcgan")}}
            print(json.dumps(row), flush=True)
            result["variants"][name]["runs"].append(
                dict(row, layers=layers))
    cli.json.parent.mkdir(parents=True, exist_ok=True)
    cli.json.write_text(json.dumps(result, indent=1))
    print(json.dumps({name: {
        "merge4_ms": [r["merge4_ms"] for r in v["runs"]],
        "dcgan_deconv1_ms": [r["dcgan_ms"].get("dcgan_gen.deconv1")
                             for r in v["runs"]],
        "sum_ms": [r["sum_ms"] for r in v["runs"]],
        "worst_rel_err": max((c.get("rel_err", 0.0) for c in v["checks"]),
                             default=None)}
        for name, v in result["variants"].items()}))
    if failed:
        print(f"bf16_levers: failed {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
