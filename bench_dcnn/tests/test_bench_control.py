"""The control: the reference, put in the program's place one precision
below the cell's, has to come out not correct, and the program not.

On the CPU at tiny sizes the control's reading stands three times or
more above the program's.  On the card (``card``) the control runs at
each cell's own size on three seeds, and every reading of the control
and of the faults breaks the cell's limit while the program's readings
keep under it."""

import json

import pytest

from bench_dcnn.tests.tiny import BENCH, ROOT, tiny_checkout

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def _readings(root, cell, device, n_prog, n_ctl, seconds):
    import subprocess
    import sys
    code = (f"import sys, json; sys.path[:0] = [{str(root)!r}, "
            f"{str(root / 'src')!r}]\n"
            "from bench_dcnn import control, harness\n"
            "import torch\n"
            "from bench_dcnn.reference import numerics\n"
            "numerics.set_ieee()\n"
            f"m = harness.Manifest(harness.Path({str(root)!r}) / "
            "'BENCHMARK.json')\n"
            f"dev = torch.device({device!r})\n"
            f"seeds = [3_100_000_000 + 104729 * i for i in range({n_prog})]\n"
            f"p = control.program_readings(m, {cell!r}, seeds, dev, "
            f"{seconds})\n"
            f"r = control.reference_readings(m, {cell!r}, seeds[:{n_ctl}], "
            "dev)\n"
            "print(json.dumps(control.summary(p, r)))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=1200, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny_checkout(tmp_path_factory.mktemp("tiny") / "co")


@pytest.mark.parametrize("cell", CELLS)
def test_control_separates_at_a_tiny_size(checkout, cell):
    summary = _readings(checkout, cell, "cpu", 2, 2, 0.5)
    assert any(row["control"] >= 3 * row["lower"] > 0
               for row in summary.values()), summary


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_and_faults_break_the_limits_on_the_card(card, cell):
    limits = json.loads((BENCH / "limits" / f"{cell}.json").read_text())
    summary = _readings(ROOT, cell, "cuda", 3, 3, 0.5)
    for k, row in summary.items():
        assert row["lower"] <= limits[k], (k, row)
    for reading in [k for k in next(iter(summary.values())) if k != "lower"]:
        assert any(row[reading] > limits[k] for k, row in summary.items()), \
            (reading, summary)
