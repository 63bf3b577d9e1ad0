"""A tiny checkout for the CPU tests: a copy of the benchmark whose
cells run the same graphs at a few channels and voxels, beside the
repository's ``src``."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench_dcnn"
TINY_CONFIGS = {
    "vnet": {"in_spatial": [16, 16, 16], "channels": [4, 8, 16, 32, 64],
             "port_reduced": True},
    "dcgan": {"channels": [128, 64, 32, 16, 3], "port_reduced": True},
}
TINY_MIX = {"batch": 2, "pool": 3}


def copy_benchmark(dest: Path, with_src: bool = True) -> Path:
    """``dest`` as a checkout holding ``BENCHMARK.json``, the benchmark
    and (``with_src``) a link to the program's sources."""
    dest.mkdir(parents=True, exist_ok=True)
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(BENCH, dest / "bench_dcnn",
                    ignore=shutil.ignore_patterns("__pycache__"))
    if with_src:
        (dest / "src").symlink_to(ROOT / "src")
    return dest


def _edit_json(path: Path, **changes) -> None:
    data = json.loads(path.read_text())
    data.update(changes)
    path.write_text(json.dumps(data))


def tiny_checkout(dest: Path) -> Path:
    """A copy whose configurations and mixes are cut to CPU sizes (the
    cells, limits and metrics unchanged)."""
    copy_benchmark(dest)
    manifest = json.loads((dest / "BENCHMARK.json").read_text())
    for c in manifest["configs"]:
        _edit_json(dest / c["file"], **TINY_CONFIGS[c["name"]])
    for w in manifest["workloads"]:
        _edit_json(dest / "bench_dcnn" / "traffic" / f"{w['traffic']}.json",
                   **TINY_MIX)
    return dest


_DRIVER = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
{patch}
from bench_dcnn.run import main
sys.exit(main({argv!r}, device={device!r}))
"""


def run_cli(root: Path, workload: str, seed: int = 3_000_000_019,
            seconds: float = 1.0, trace: int = 0, device: str | None = "cpu",
            patch: str = "", timeout: float = 300):
    """Run ``bench_dcnn/run.py`` of ``root`` in a fresh interpreter, on
    ``device`` without looking for a card (None: as the command line),
    after the code ``patch``; returns the finished process."""
    argv = ["--workload", workload, "--seed", str(seed), "--seconds",
            str(seconds), "--trace", str(trace)]
    code = _DRIVER.format(root=str(root), src=str(root / "src"),
                          patch=patch, argv=argv, device=device)
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=timeout)


def result(proc) -> dict:
    """The result line of a finished run."""
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])
