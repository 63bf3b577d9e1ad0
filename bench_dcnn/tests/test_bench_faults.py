"""Whole runs with the timed path broken underneath come out not
correct: one for each fault a cell can have.  The runs skip the look for
a card and use the plain versions at tiny sizes."""

import json

import pytest

from bench_dcnn.tests.tiny import BENCH, ROOT, result, run_cli, tiny_checkout

ALTERED = """
import bench_dcnn.models.{mod} as M
_fwd = M.Program.forward
def forward(self, params, x):
    y = _fwd(self, params, x).clone()
    y[-1] = y[0]                     # one answer altered where produced
    return y
M.Program.forward = forward
"""

UNCHANGED = """
import bench_dcnn.models.{mod} as M
_step = M.Program.train_step
def train_step(self, opt):
    step = _step(self, opt)
    def frozen(params, state, batch):
        _, _, metrics = step(params, state, batch)
        return params, state, metrics    # the state returned unchanged
    return frozen
M.Program.train_step = train_step
"""

HALF = """
import bench_dcnn.models.{mod} as M
_step = M.Program.train_step
def train_step(self, opt):
    step = _step(self, opt)
    def half(params, state, batch):    # the mean over half the batch
        return step(params, state, {{k: v[: v.shape[0] // 2]
                                     for k, v in batch.items()}})
    return half
M.Program.train_step = train_step
"""

FAULTS = {"infer": [(ALTERED, "altered")],
          "train": [(UNCHANGED, "unchanged"), (HALF, "half")]}


def _cases():
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    files = {c["name"]: c["file"] for c in manifest["configs"]}
    for w in manifest["workloads"]:
        model = json.loads((ROOT / files[w["config"]]).read_text())["model"]
        kind = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                          .read_text())["kind"]
        for fault, tag in FAULTS[kind]:
            yield w["name"], model, fault, tag


CASES = list(_cases())


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny_checkout(tmp_path_factory.mktemp("tiny") / "co")


@pytest.mark.parametrize("cell", sorted({c[0] for c in CASES}))
def test_sound_run_is_correct(checkout, cell):
    res = result(run_cli(checkout, cell))
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0


@pytest.mark.parametrize("cell,mod,fault", [c[:3] for c in CASES],
                         ids=[f"{c[0]}-{c[3]}" for c in CASES])
def test_broken_run_is_not_correct(checkout, cell, mod, fault):
    res = result(run_cli(checkout, cell, patch=fault.format(mod=mod)))
    assert res["correct"] is False, res["checks"]
    assert res["failed"] > 0
