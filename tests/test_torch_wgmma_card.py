"""Kernel 1's TMA + wgmma route on the card: ``pytest -m card
tests/test_torch_wgmma_card.py`` (skips without an NVIDIA GPU).

Each case of ``chip_smoke.WGMMA_CASES`` runs ``deconv_fwd`` on bf16
operands the planner gives the route (``tiling.plan_wgmma``), with bias,
scale and an activation, in bf16 and in f32 output, twice
(``chip_smoke.wgmma_case``): the two runs give the same bits, the entry
reports the wgmma staging, and the output holds against float64 of the
same bf16 operands (the plain version), f32 output within
``chip_smoke.W8_TOL`` of the largest |y| and bf16 within its bf16 gate.
The cases: DCGAN's deconv1-3 at batch 64 and 1,024, V-Net's up1-3 at
batch 8, a ragged grid cropped in front, a conv's dx geometry (crop 1, a
window past the Eq. (1) extent), two groups, and a dilation that leaves
phases without taps."""

import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

CASES = chip_smoke.WGMMA_CASES


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the card)")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_wgmma_route_against_float64(card, case):
    row = chip_smoke.wgmma_case(case, card)
    assert row["ok"], row
