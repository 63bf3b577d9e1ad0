"""The port stands alone: no JAX, nothing of ``repro``, no quiet CPU.

A fresh interpreter imports every module of ``repro_torch`` and must not
have loaded ``jax`` or any ``repro`` module; no source file under
``src/repro_torch`` imports either; and an engine built without naming a
device refuses to run on a machine without CUDA instead of carrying on on
the CPU.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.engine import EngineError, UniformEngine  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.")
             or k == "repro" or k.startswith("repro."))
print(len(names), bad)
"""


def test_importing_every_module_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 15 and bad == "[]", out.stdout


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_imports_jax_or_repro():
    files = sorted(PORT.rglob("*.py"))
    assert files
    for f in files:
        for mod in _imported_modules(f):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), (f, mod)


def test_engine_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        assert UniformEngine().device.type == "cuda"
    else:
        with pytest.raises(EngineError, match="device='cpu'"):
            UniformEngine()
    assert UniformEngine(device="cpu").device.type == "cpu"


def test_quant_package_stands_alone():
    """``repro_torch.quant`` ports ``repro.quant`` (whose calibration pulls
    in jax through ``repro.obs``) without importing either."""
    code = ("import sys, repro_torch.quant as q; "
            "print(sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'repro')), q.Precision.__module__)")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[]", "repro_torch.quant.precision"]


@pytest.mark.parametrize("module", ["repro_torch.tune",
                                    "repro_torch.launch.tune",
                                    "repro_torch.obs.report",
                                    "repro_torch.obs.export"])
def test_telemetry_and_tuning_modules_stand_alone(module):
    """The runtime report, the exporters and the autotuner port modules
    of the JAX package whose own imports pull in jax (``repro.obs`` ->
    ``obs/report.py``, ``repro.tune`` -> ``repro.core``); each loads
    alone without either."""
    code = (f"import sys, importlib; importlib.import_module({module!r}); "
            "print(sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'repro')))")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[]"]
