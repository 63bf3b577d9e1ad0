#!/usr/bin/env python3
"""Compare the compiled SASS of the forward kernels of two source trees.

    python3 scripts/sass_diff.py --parent A/src --src B/src
                                 [--kernel igemm_kernel ...]

Builds each tree's kernel library (its own ``repro_torch.kernels.build``,
in a process of its own), disassembles both with ``cuobjdump -sass`` and
compares, function by function, the kernels whose names hold each
``--kernel`` (default: the FMA, TF32 and s8 routes' ``igemm_kernel``,
``igemm_tf32_kernel``, ``igemm_s8_kernel``): a function's instructions
are compared as text with their offsets, so any change of code shows.
Prints one JSON line per kernel name (functions, identical, differing,
missing on either side) and exits non-zero when any function differs or
is missing.  Needs the CUDA toolkit (``nvcc``, ``cuobjdump``); run it on
the card's machine.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

KERNELS = ("igemm_kernel", "igemm_tf32_kernel", "igemm_s8_kernel")


def library(src: Path) -> Path:
    """Build ``src``'s kernel library in a child process; its path."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from repro_torch.kernels import build; print(build.build()[0])")
    out = subprocess.run([sys.executable, "-c", code, str(src)],
                         capture_output=True, text=True, check=True,
                         timeout=1200)
    return Path(out.stdout.strip().splitlines()[-1])


def functions(lib: Path) -> dict[str, list[str]]:
    """Mangled function name -> the SASS text of each object's copy
    (``cuobjdump -sass``)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=600).stdout
    out = {}
    for block in re.split(r"\n\s*Function : ", text)[1:]:
        name, body = block.split("\n", 1)
        # every object's copy of a function is kept (and compared)
        lines = [ln.strip() for ln in body.splitlines()
                 if re.match(r"\s*/\*[0-9a-f]{4,}\*/", ln)]
        out.setdefault(name.strip(), [])
        out[name.strip()].append("\n".join(lines))
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", type=Path, required=True)
    parser.add_argument("--src", type=Path, required=True)
    parser.add_argument("--kernel", action="append", default=None)
    cli = parser.parse_args()
    old = functions(library(cli.parent))
    new = functions(library(cli.src))
    rc = 0
    for kernel in cli.kernel or KERNELS:
        pat = re.compile(r"\d" + kernel + r"I")     # the mangled name
        names = sorted(n for n in set(old) | set(new) if pat.search(n))
        same = [n for n in names if n in old and n in new
                and sorted(old[n]) == sorted(new[n])]
        diff = [n for n in names if n in old and n in new and n not in same]
        missing = [n for n in names if n not in old or n not in new]
        print(json.dumps({"kernel": kernel, "functions": len(names),
                          "identical": len(same), "differing": len(diff),
                          "missing": len(missing),
                          "first_differing": diff[:2],
                          "first_missing": missing[:2]}), flush=True)
        if diff or missing or not names:
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
