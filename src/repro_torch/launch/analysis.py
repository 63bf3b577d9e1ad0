"""Roofline terms of one abstract step (JAX ``launch/analysis.py``).

The reference reads its terms from a compiled, SPMD-partitioned XLA
module.  The port traces the step itself, once, as one rank of the mesh
(a mesh without a world, ``launch.mesh.make_production_mesh(world=
False)``), on ``meta`` tensors: nothing is allocated and nothing runs.
``analyse_step`` gives the same ``roofline``, ``collectives`` and
``memory`` keys as the reference's ``analyse_compiled``:

* FLOPs per device: ``torch.utils.flop_counter.FlopCounterMode``'s count
  of the rank's products (matmul, bmm, conv, attention), a backward's and
  a checkpoint's recompute included; it counts no elementwise work.  A
  hand kernel is a ctypes call it cannot see into: its wrappers tally
  the MACs their kernels would execute on ``meta`` shapes
  (``kernels.common.dry_tally``), and 2 x those MACs are added apart
  (``kernel_flops_per_device``, f32 work at the f32 rate).
* Collective bytes per device: the rank's ``sharding.mesh.
  collective_stats``, which counts what the rank hands the backend,
  turned into the reference's convention, each collective's RESULT
  shape: an all-gather counts the gathered tensor (n x what was sent), a
  reduce-scatter its shard (1 / n), an all-reduce its tensor
  (``collective_bytes``).
* Bytes per device: the sum over the step's ops of their operands' and
  results' bytes, an unfused upper bound as the reference's CPU-backend
  "bytes accessed" is; ``memory_s`` takes the fused estimate
  ``analytic_hbm_bytes`` where there is one, as the reference's does.
* Memory: ``argument_bytes`` exactly from the argument tensors (this
  rank's blocks), ``output_bytes`` from the results, ``temp_bytes`` the
  peak of live storages that the step made (not views of its arguments,
  nor its writes into them), less its outputs, and
  ``alias_bytes`` what the step hands back in place of its inputs (a
  train step's parameters and moments, a decode step's cache), as the
  reference's donation does.

The rates are an NVIDIA H100 SXM's, from its data sheet (``PERF.md``
section 3, device row): 989 TFLOP/s dense bf16 on the tensor cores, 67
TFLOP/s f32 on the CUDA cores, 3.35 TB/s of HBM3.  A production
``model`` axis of 16 spans two 8-GPU NVLink nodes, so its collectives
are bound by the per-GPU InfiniBand link between them (NDR, 400 Gb/s =
50 GB/s a direction); NVLink's 450 GB/s a direction holds only inside a
node.
"""

from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import tree as _tree
# core before kernels.common: core.tiling and kernels.common import each
# other, and only this order resolves
import repro_torch.core  # noqa: F401,I100
from repro_torch.kernels import common as _kcommon
from repro_torch.sharding import mesh as _mesh

PEAK_FLOPS = 989e12          # H100 SXM, dense bf16 tensor cores
F32_FLOPS = 67e12            # H100 SXM, f32 CUDA cores (the hand kernels)
HBM_BW = 3.35e12             # H100 SXM HBM3, bytes/s
COLL_BW = 50e9               # InfiniBand NDR per GPU, bytes/s a direction

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def _op_kind(op: str) -> str:
    """The reference's collective name of a ``collective_stats`` op
    (``"all_reduce_sum[blk_out]"`` -> ``"all-reduce"``)."""
    base = op.split("[")[0]
    if base.startswith("all_reduce"):
        return "all-reduce"
    return {"all_gather": "all-gather",
            "reduce_scatter": "reduce-scatter"}[base]


def collective_bytes(stats: dict, mesh) -> dict:
    """Per-op-type ``{count, bytes}`` and ``total_bytes`` of one rank's
    ``collective_stats()`` on ``mesh``, in the reference's convention:
    each collective's RESULT bytes (an all-gather the gathered tensor, a
    reduce-scatter its shard, an all-reduce the reduced tensor).
    ``sent_bytes`` is the stats' own sum, what the rank handed the
    backend."""
    out = {op: {"count": 0, "bytes": 0} for op in COLLECTIVES}
    sent = 0
    for (op, axes), (calls, nbytes) in stats.items():
        kind = _op_kind(op)
        n = _mesh.axis_size(mesh, axes)
        got = {"all-gather": nbytes * n,
               "reduce-scatter": nbytes // n}.get(kind, nbytes)
        out[kind]["count"] += calls
        out[kind]["bytes"] += got
        sent += nbytes
    out["total_bytes"] = sum(v["bytes"] for v in out.values()
                             if isinstance(v, dict))
    out["sent_bytes"] = sent
    return out


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float          # ops' operand + result bytes (UNFUSED
                                     # upper bound)
    collective_bytes_per_device: float
    chips: int
    model_flops: float = 0.0         # analytic 6*N*D (global)
    analytic_bytes_per_device: float = 0.0   # fused-traffic estimate
    # of flops_per_device, the hand kernels' (f32, at F32_FLOPS)
    kernel_flops_per_device: float = 0.0

    @property
    def compute_s(self) -> float:
        k = self.kernel_flops_per_device
        return (self.flops_per_device - k) / PEAK_FLOPS + k / F32_FLOPS

    @property
    def memory_s(self) -> float:
        """Memory term from the fused-traffic estimate when available (the
        op-by-op count has no fusion and overcounts)."""
        b = self.analytic_bytes_per_device or self.bytes_per_device
        return b / HBM_BW

    @property
    def memory_s_hlo_upper(self) -> float:
        """The unfused op-by-op bytes' term (the reference's HLO count's
        name)."""
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_device / COLL_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """The useful-compute lower bound over the step's dominant term
        (as if every term overlapped perfectly)."""
        useful = self.model_flops / (self.chips * PEAK_FLOPS)
        return useful / self.step_s if self.step_s > 0 else 0.0

    @property
    def useful_flops_ratio(self) -> float:
        """Model FLOPs over the counted product FLOPs of all chips: the
        waste of remat and redundant work.  The count holds products
        only (no elementwise work), so this reads higher than a count
        of every operation would."""
        global_flops = self.flops_per_device * self.chips
        return self.model_flops / global_flops if global_flops else 0.0

    def to_dict(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "analytic_bytes_per_device": self.analytic_bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "chips": self.chips,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "memory_s_hlo_upper": self.memory_s_hlo_upper,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "step_s": self.step_s,
            "roofline_fraction": self.roofline_fraction,
            "useful_flops_ratio": self.useful_flops_ratio,
        }


def analytic_hbm_bytes(kind: str, *, n_params: int, param_shards: int,
                       tokens_local: int, d_model: int, n_layers: int,
                       vocab_local: int = 0, xent_chunks: int = 0,
                       cache_bytes_local: int = 0,
                       opt_bits: int = 32, act_factor: float = 8.0) -> float:
    """Fused HBM traffic estimate per device per step (the reference's
    formula, verbatim).

    train:  weights bf16 read fwd + remat re-read (2x2) + grad write +
            optimizer moment r/w + master r/w; activations ~act_factor
            residual-stream passes per layer; CE table re-read per chunk x3.
    prefill: weights once + activations (no backward).
    decode:  weights once + KV/state cache read-write -- the classic
            decode memory wall.
    """
    p_loc = n_params / max(param_shards, 1)
    if kind == "train":
        opt_rw = 32.0 if opt_bits == 32 else 10.0     # f32 vs int8 moments
        w = p_loc * (2 + 2) + p_loc * opt_rw
        acts = tokens_local * d_model * 2 * n_layers * act_factor
        ce = 3 * xent_chunks * vocab_local * d_model * 2 \
            + 3 * tokens_local * d_model * 2
        return w + acts + ce
    if kind == "prefill":
        return p_loc * 2 + tokens_local * d_model * 2 * n_layers * \
            (act_factor / 2) + cache_bytes_local
    # decode
    return p_loc * 2 + cache_bytes_local * 1.5 + \
        tokens_local * d_model * 2 * n_layers * 4


def model_flops_estimate(kind: str, n_active_params: int, tokens: int,
                         extra: float = 0.0) -> float:
    """6*N*D for train, 2*N*D for inference (fwd only), + extra."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active_params * tokens + extra


def tree_bytes(tree) -> int:
    """The bytes of a tree's tensor leaves (their elements', whatever
    storage they view)."""
    return sum(t.numel() * t.element_size() for t in _tree.leaves(tree)
               if isinstance(t, torch.Tensor))


class StepTally(TorchDispatchMode):
    """Inside the block, every op's operand and result bytes
    (``accessed``; a view's none), and the live bytes of the storages the
    ops made (``peak``: their most at once).  A storage counts from the
    op that made it until the last tensor on it is gone; the storages of
    ``args`` (the step's arguments) never count, so a view of an
    argument, or an op that writes into one in place, adds nothing."""

    def __init__(self, args=()):
        super().__init__()
        self.accessed = 0
        self.inputs = {t.untyped_storage()._cdata
                       for t in _tree.leaves(args)
                       if isinstance(t, torch.Tensor)}
        self.live: dict[int, list[int]] = {}
        self.current = 0
        self.peak = 0

    def _drop(self, key: int) -> None:
        entry = self.live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.current -= entry[0]
            del self.live[key]

    def _touch(self, tensors) -> None:
        for t in tensors:
            if isinstance(t, torch.Tensor):
                self.accessed += t.numel() * t.element_size()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        results = tree_flatten(out)[0]
        if not func.is_view:            # a view moves no byte
            self._touch(tree_flatten((args, kwargs))[0])
            self._touch(results)
        for t in results:
            if not isinstance(t, torch.Tensor):
                continue
            storage = t.untyped_storage()
            key = storage._cdata
            if key in self.inputs:
                continue
            entry = self.live.get(key)
            if entry is None:
                entry = self.live[key] = [storage.nbytes(), 0]
                self.current += entry[0]
                self.peak = max(self.peak, self.current)
            entry[1] += 1
            weakref.finalize(t, self._drop, key)
        return out


def trace_step(fn, args, mesh):
    """Run ``fn(*args)`` once on ``meta`` tensors, counted: returns
    ``(out, counts)`` with ``counts`` the products' FLOPs, the kernels'
    tally, the rank's collective stats, the ops' bytes and the peak of
    live tensors the step made."""
    _mesh.reset_collective_stats()
    _kcommon.reset_dry_tally()
    flops = FlopCounterMode(display=False)
    tally = StepTally(args)
    with flops, tally:
        out = fn(*args)
    kernels = _kcommon.dry_tally()
    stats = _mesh.collective_stats()
    counts = {"product_flops": flops.get_total_flops(),
              "kernels": kernels,
              "kernel_flops": 2 * sum(v["macs"] for v in kernels.values()),
              "collective_stats": stats,
              "collectives": collective_bytes(stats, mesh),
              "accessed_bytes": tally.accessed,
              "peak_bytes": tally.peak}
    return out, counts


def analyse_step(fn, args, mesh, chips: int, model_flops: float = 0.0,
                 analytic_bytes: float = 0.0, alias=()):
    """Trace ``fn(*args)`` abstractly (``trace_step``) as one rank of
    ``mesh`` and return ``(out, record)``, ``record`` the reference's
    ``roofline``, ``collectives`` and ``memory`` keys (see the module
    docstring), ``kernel_flops`` (2 x the hand kernels' MACs, in
    ``flops_per_device``) and ``kernels`` (the wrappers' dry tally).
    ``alias``: the arguments the step hands back in place (donated)."""
    out, counts = trace_step(fn, args, mesh)
    kflops = float(counts["kernel_flops"])
    rl = Roofline(
        flops_per_device=float(counts["product_flops"]) + kflops,
        bytes_per_device=float(counts["accessed_bytes"]),
        collective_bytes_per_device=float(
            counts["collectives"]["total_bytes"]),
        chips=chips, model_flops=model_flops,
        analytic_bytes_per_device=analytic_bytes,
        kernel_flops_per_device=kflops)
    arg_b, out_b = tree_bytes(args), tree_bytes(out)
    alias_b = tree_bytes(alias)
    temp_b = max(counts["peak_bytes"] - out_b, 0)
    return out, {
        "roofline": rl.to_dict(),
        "collectives": counts["collectives"],
        "memory": {
            "argument_bytes": arg_b,
            "output_bytes": out_b,
            "temp_bytes": temp_b,
            "alias_bytes": alias_b,
            "total_per_device": arg_b + out_b + temp_b - alias_b,
        },
        "kernel_flops": kflops,
        "kernels": counts["kernels"],
    }
