"""Whole runs of the command line: on the card each cell is correct and
reports its metrics; without a card, or without the program beside the
benchmark, a run exits non-zero and prints no result."""

import json

import pytest

from bench_dcnn.tests.tiny import ROOT, copy_benchmark, run_cli

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_without_a_card_a_run_prints_nothing(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = run_cli(ROOT, CELLS[0], device=None)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_benchmark_alone_prints_nothing(tmp_path):
    root = copy_benchmark(tmp_path / "co", with_src=False)
    proc = run_cli(root, CELLS[0], device="cpu")
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell, trace):
    proc = run_cli(ROOT, cell, seconds=2, trace=trace, device=None,
                   timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu"
    want = {m["name"] for m in MANIFEST["end_to_end" if not trace
                                        else "per_layer"]
            if cell in m.get("workloads", [cell])}
    if trace:
        assert res["device"]["busy_s"] > 0
        assert set(res["metrics"]) <= want and res["metrics"]
    else:
        assert set(res["metrics"]) == want
