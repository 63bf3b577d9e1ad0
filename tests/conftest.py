# NOTE: do NOT set XLA_FLAGS / host device count here — smoke tests and
# benches must see the real single CPU device.  Distributed tests spawn
# subprocesses with their own env (tests/test_distributed.py).
import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.RandomState(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA GPU; skips without one (run "
        "them with `pytest -m card` on the card)")
