"""The one precision policy of the port's engine (JAX
``quant/precision.py``).

The paper's headline operating point is fixed-point arithmetic; this
module is the policy surface for it.  A frozen :class:`Precision` bundles
every dtype decision of the engine:

* ``storage``    — dtype activations are stored in between layers (what
  ``EngineConfig.preferred_element_type`` spells; ``None`` keeps the
  input's).
* ``compute``    — dtype operands are cast to before the sums (``None`` =
  leave operands as they arrive); validated, carried, not read by the
  kernels, as in the reference.
* ``accumulate`` — the kernels' accumulator dtype.  The Hopper kernels sum
  in f32 registers, so only ``torch.float32`` is accepted.
* ``weight_quant`` / ``act_quant`` — ``"none"`` or ``"int8"``.  int8
  weights reach the deconv and conv kernels as 1-byte operands (launch
  counts identical to f32) with the per-channel dequant scale applied in
  the fused epilogue, before the store cast; int8 activations are
  quantized per tensor on the device and their scale folds into it.
* ``channel_axis`` — the weight axis scales are computed over.  The weight
  layout is ``(*kernel, cin, cout)``, so ``-1`` means per-cout: the only
  axis whose scale commutes with the ci/tap contraction.

``weight_bytes``/``act_bytes`` keep the JAX planner's widths
(``NOMINAL_OPERAND_BYTES`` = 2 for a float operand, 1 for int8) for parity
with the reference's API.  The port's planner (``core/tiling.py``) charges
the operands' real element sizes instead: ``operand_bytes`` gives them (4
for f32, 2 for bf16, 1 for int8), so every f32/bf16 plan is unchanged.

Unknown combinations raise at construction (config time), never at a
launch.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

QUANT_MODES = ("none", "int8")

# the JAX planner's nominal width of an unquantized operand (bytes), kept
# for parity; the port's planner takes real element sizes (operand_bytes)
NOMINAL_OPERAND_BYTES = 2
INT8_OPERAND_BYTES = 1


def _canon_dtype(value: Any):
    """``None`` passes through; anything else must be a torch dtype."""
    if value is None or isinstance(value, torch.dtype):
        return value
    raise TypeError(f"expected a torch.dtype or None, got {value!r}")


@dataclasses.dataclass(frozen=True)
class Precision:
    """Frozen, hashable precision policy; see the module docstring."""

    compute: Any = None
    accumulate: Any = torch.float32
    storage: Any = None
    weight_quant: str = "none"
    act_quant: str = "none"
    channel_axis: int = -1

    def __post_init__(self) -> None:
        for name in ("compute", "accumulate", "storage"):
            _canon_dtype(getattr(self, name))
        if self.accumulate != torch.float32:
            raise ValueError(
                "Precision.accumulate must be float32: the kernels "
                f"accumulate in f32 registers (got {self.accumulate})")
        for field in ("weight_quant", "act_quant"):
            mode = getattr(self, field)
            if mode not in QUANT_MODES:
                raise ValueError(
                    f"Precision.{field}={mode!r} not supported; "
                    f"choose from {QUANT_MODES}")
        if self.act_quant == "int8" and self.weight_quant != "int8":
            raise ValueError(
                "Precision(act_quant='int8') requires weight_quant='int8': "
                "activation scales are folded into the per-channel weight "
                "scales inside the fused epilogue")
        for name in ("compute", "storage"):
            dt = getattr(self, name)
            if dt is not None and (dt.is_complex or dt == torch.bool):
                raise ValueError(f"Precision.{name}={dt} is not a real "
                                 f"numeric dtype")
        if self.channel_axis != -1:
            raise ValueError(
                "Precision.channel_axis must be -1 (per-cout): only the "
                "output-channel scale commutes with the ci/tap contraction "
                "and can be fused into the epilogue")

    # ---- planner widths (the JAX planner's nominal ones) -----------------
    @property
    def weight_bytes(self) -> int:
        """The JAX planner's width of a weight element under this
        policy."""
        if self.weight_quant == "int8":
            return INT8_OPERAND_BYTES
        return NOMINAL_OPERAND_BYTES

    @property
    def act_bytes(self) -> int:
        """The JAX planner's width of an activation element under this
        policy."""
        if self.act_quant == "int8":
            return INT8_OPERAND_BYTES
        return NOMINAL_OPERAND_BYTES

    def operand_bytes(self, dtype: torch.dtype) -> tuple[int, int]:
        """The real widths ``(activation, weight)`` the port's planner
        charges when float operands arrive in ``dtype``: 1 byte for an
        int8 operand, ``dtype``'s element size otherwise."""
        size = torch.empty((), dtype=dtype).element_size()
        return (INT8_OPERAND_BYTES if self.act_quant == "int8" else size,
                INT8_OPERAND_BYTES if self.weight_quant == "int8" else size)

    @property
    def quantized(self) -> bool:
        return self.weight_quant != "none" or self.act_quant != "none"

    def describe(self) -> str:
        bits = []
        if self.weight_quant != "none":
            bits.append(f"w:{self.weight_quant}")
        if self.act_quant != "none":
            bits.append(f"a:{self.act_quant}")
        if self.storage is not None:
            bits.append(f"s:{str(self.storage).split('.')[-1]}")
        return "+".join(bits) if bits else "f32"
