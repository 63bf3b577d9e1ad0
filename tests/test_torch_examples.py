"""The port's examples (``repro_torch.examples``) run in-process on the CPU.

Each example's ``main(argv)`` runs with ``--device cpu`` (the kernels'
plain versions) on its reduced configuration, two steps where it trains:
the printed schedule, finite losses, and the server's fallback and
recovery under ``--inject-faults``, whose counts are those the JAX
package's ``examples/serve_dcnn.py --inject-faults`` prints (1 fallback,
1 recovery, 3 retries).  Without ``--device`` an example runs on the card,
so here it refuses.
"""

import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import EngineError  # noqa: E402
from repro_torch.examples import (  # noqa: E402
    quickstart,
    segment_vnet3d,
    serve_dcnn,
    train_dcgan,
)

SRC = Path(__file__).resolve().parents[1] / "src"
CPU = ["--device", "cpu"]


def test_quickstart(capsys):
    quickstart.main(CPU)
    out = capsys.readouterr().out
    assert out.rstrip().endswith("quickstart OK")
    assert "schedule[pallas@cpu]" in out and "vnet.skip1" in out
    assert "plan sources {'tuned': 2, 'heuristic': 0}" in out


def test_train_dcgan_two_steps_then_resume(capsys, tmp_path):
    argv = CPU + ["--steps", "2", "--method", "pallas", "--checkpoint-dir",
                  str(tmp_path / "ck")]
    tr = train_dcgan.main(argv)
    out = capsys.readouterr().out
    assert "schedule[pallas@cpu] batch=2 layers=4" in out
    assert "dcgan.deconv4" in out and "bias+tanh" in out
    assert tr.step == 2 and "done at step 2" in out
    losses = [v for rec in tr.metrics_log for k, v in rec.items()
              if k.endswith("loss")]
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses)
    # a second run finds the checkpoint of the last step
    again = train_dcgan.main(argv)
    assert again.step == 2
    assert "resumed from step 2" in capsys.readouterr().out


def test_train_dcgan_on_a_reference_method(capsys, tmp_path):
    tr = train_dcgan.main(CPU + ["--steps", "1", "--method", "xla",
                                 "--checkpoint-dir", str(tmp_path)])
    assert "schedule[xla@cpu]" in capsys.readouterr().out
    assert tr.step == 1


def test_segment_vnet3d_two_steps(capsys):
    res = segment_vnet3d.main(CPU + ["--steps", "2", "--method", "pallas"])
    out = capsys.readouterr().out
    assert "schedule[pallas@cpu] batch=2" in out and "vnet.merge1" in out
    assert len(res["losses"]) == 2
    assert all(math.isfinite(v) for v in res["losses"])
    assert 0.0 <= res["iou"] <= 1.0 and "IoU on held-out volumes" in out


@pytest.mark.parametrize("faults", [False, True])
def test_serve_dcnn(capsys, faults):
    stats = serve_dcnn.main(CPU + (["--inject-faults"] if faults else []))
    out = capsys.readouterr().out
    assert out.rstrip().endswith("serve_dcnn OK")
    assert stats["completed"] == 8
    want = (1, 1, 3) if faults else (0, 0, 0)
    assert (stats["fallbacks"], stats["recoveries"], stats["retries"]) == want
    # the faulted bucket recovered: every bucket ends on the kernels
    assert {b["engine"] for b in stats["buckets"].values()} == {"pallas"}
    assert ("on xla" in out) == faults


def test_examples_run_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(EngineError):
        quickstart.main([])


def test_an_example_runs_as_a_module():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.serve_dcnn", "--device",
         "cpu", "--requests", "2"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.rstrip().endswith("serve_dcnn OK")
