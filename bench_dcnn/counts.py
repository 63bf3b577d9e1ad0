"""Operations and bytes of the work a batch or a training step needs,
from the layer shapes of the reference's graph alone.

A conv or deconv counts its useful multiply-adds: per dim, the pairs of
position and tap whose input and output both lie inside the tensors
(no padding, no cropped border, no inserted zero), times the input and
output channels.  A pass (``fwd``, ``dx``, ``dw``) does that many
multiply-adds, two operations each.  Its bytes are each tensor it reads
or writes, once: ``fwd`` reads the input, the weights (and bias) and
writes the output; ``dx`` reads the output's gradient and the weights
and writes the input's; ``dw`` reads the input and the output's
gradient and writes the weights'.  A concatenation moves its bytes and
does no operation; a dense layer (``matmul``) is a product of ``k`` by
``n`` per sample."""

from __future__ import annotations

import math


def _pairs(n_in: int, n_out: int, k: int, s: int, lo: int, op: str) -> int:
    if op == "conv":
        return sum(1 for o in range(n_out) for t in range(k)
                   if 0 <= o * s + t - lo < n_in)
    return sum(1 for i in range(n_in) for t in range(k)
               if 0 <= i * s + t - lo < n_out)


def useful_macs(nd: dict) -> int:
    """Multiply-adds of one sample's pass through a conv or deconv, or a
    dense layer."""
    if nd["op"] == "matmul":
        return nd["m_per_sample"] * nd["k"] * nd["n"]
    per_dim = [_pairs(i, o, k, s, lo, nd["op"])
               for i, o, k, s, (lo, _) in zip(nd["in_spatial"],
                                              nd["out_spatial"],
                                              nd["kernel"], nd["stride"],
                                              nd["padding"])]
    return math.prod(per_dim) * nd["cin"] * nd["cout"]


def _elements(nd: dict) -> tuple[int, int, int]:
    """(input per sample, output per sample, weights and bias)."""
    if nd["op"] == "matmul":
        return (nd["m_per_sample"] * nd["k"], nd["m_per_sample"] * nd["n"],
                nd["k"] * nd["n"])
    x = math.prod(nd["in_spatial"]) * nd["cin"]
    y = math.prod(nd["out_spatial"]) * nd["cout"]
    if nd["op"] == "concat":
        return x, y, 0
    w = math.prod(nd["kernel"]) * nd["cin"] * nd["cout"]
    return x, y, w + (nd["cout"] if nd.get("bias") else 0)


def pass_counts(nd: dict, pas: str, batch: int,
                elem_bytes: int) -> tuple[int, int]:
    """(operations, bytes) of one pass over ``batch`` samples."""
    x, y, w = _elements(nd)
    flops = 0 if nd["op"] == "concat" else 2 * useful_macs(nd) * batch
    if pas == "fwd" or nd["op"] == "concat":
        elems = (x + y) * batch + w
    elif pas == "dx":
        elems = (y + x) * batch + w
    elif pas == "dw":
        elems = (x + y) * batch + w
    else:
        raise ValueError(f"unknown pass {pas!r}")
    return flops, elems * elem_bytes


def totals(work, batch: int, elem_bytes: int) -> list[dict]:
    """One row per (node, pass) of ``work`` (a reference's ``work()``):
    ``name``, ``pass``, ``flops``, ``bytes``."""
    rows = []
    for nd, passes in work:
        for pas in passes:
            f, b = pass_counts(nd, pas, batch, elem_bytes)
            rows.append({"name": nd["name"], "pass": pas, "flops": f,
                         "bytes": b})
    return rows


def flops(work, batch: int) -> int:
    return sum(r["flops"] for r in totals(work, batch, 1))


def roofline_seconds(work, batch: int, elem_bytes: int, peak_flops: float,
                     peak_bytes: float) -> float:
    """The least time the chip could take for ``work``: per pass, the
    larger of its operations at the peak rate and its bytes at the peak
    bandwidth."""
    return sum(max(r["flops"] / peak_flops, r["bytes"] / peak_bytes)
               for r in totals(work, batch, elem_bytes))
