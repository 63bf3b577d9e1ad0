"""The numbers that decide ``correct``, each held against its limit.

Inference: ``out_rel_rms``, the largest over the compared samples of
``||y - y_ref|| / ||y_ref||``, one served sample (a volume, an image) at
a time, so that one altered answer in a batch shows whole.

Training (the first steps of the run, followed by the reference):
``loss_gap``, the largest ``|l - l_ref| / |l_ref|`` over the steps and
losses; ``grad_gap``, the worst leaf's ``| ||g|| - ||g_ref|| |`` over
the larger of ``||g_ref||`` and the median leaf's, for the first
gradient as the optimizer holds it; ``update_gap``, the same for each
leaf's change over the steps.  Leaves whose reference gradient is under
a thousandth of the median leaf's (nought to rounding) are left out of
both leaf numbers."""

from __future__ import annotations

import math
import statistics

import torch

NEGLIGIBLE = 1e-3


def rel_rms(y: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest relative RMS error of one sample (the leading dim)."""
    y = y.to(torch.float32).reshape(y.shape[0], -1)
    ref = ref.to(torch.float32).reshape(ref.shape[0], -1)
    err = (y - ref).norm(dim=1) / ref.norm(dim=1).clamp(min=1e-30)
    return float(err.max())


def loss_gap(losses: list[dict], ref: list[dict]) -> float:
    gaps = [abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
            for a, b in zip(losses, ref, strict=True) for k in b]
    return max(gaps)


def counted_leaves(ref_grad_norms: dict) -> list[str]:
    med = statistics.median(ref_grad_norms.values())
    return [k for k, n in ref_grad_norms.items() if n >= NEGLIGIBLE * med]


def leaf_gap(norms: dict, ref: dict, leaves: list[str]) -> float:
    """The worst leaf's gap of norms, against the larger of its reference
    norm and the median leaf's."""
    med = statistics.median(ref[k] for k in leaves)
    return max(abs(norms[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in leaves)


def training_numbers(program: dict, reference: dict) -> dict:
    """``loss_gap``, ``grad_gap`` and ``update_gap`` of what the program's
    first steps gave (``losses``, ``grad_norms``, ``change_norms``)
    against the reference's."""
    if set(program["grad_norms"]) != set(reference["grad_norms"]):
        raise ValueError("the program's leaves are not the reference's: "
                         f"{sorted(program['grad_norms'])} vs "
                         f"{sorted(reference['grad_norms'])}")
    leaves = counted_leaves(reference["grad_norms"])
    return {
        "loss_gap": loss_gap(program["losses"], reference["losses"]),
        "grad_gap": leaf_gap(program["grad_norms"],
                             reference["grad_norms"], leaves),
        "update_gap": leaf_gap(program["change_norms"],
                               reference["change_norms"], leaves),
    }


def judge(numbers: dict, limits: dict) -> list[dict]:
    """Each number beside its limit; one that is not finite fails."""
    return [{"name": k, "value": v, "limit": limits[k],
             "ok": math.isfinite(v) and v <= limits[k]}
            for k, v in numbers.items()]
