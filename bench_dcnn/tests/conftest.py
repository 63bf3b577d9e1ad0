"""The benchmark's own tests: ``python -m pytest bench_dcnn/tests``.

Tests marked ``card`` need an NVIDIA GPU; each decides inside the test
(the ``card`` fixture) and skips without one.  The rest run on the CPU,
on the program's plain versions at tiny sizes."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the card)")
    return torch.device("cuda", 0)
