"""repro_torch.quant — the port's one quantization codepath (JAX
``repro.quant``).

``Precision`` is the engine's precision policy (``EngineConfig(precision=
...)``); ``qint8`` holds the single int8 round/clip/scale implementation;
``calibrate`` turns float weight trees into the ``{w_q, scale}`` entries
the engine's fused-dequant kernels consume.
"""

from repro_torch.quant.precision import (  # noqa: F401
    INT8_OPERAND_BYTES,
    NOMINAL_OPERAND_BYTES,
    QUANT_MODES,
    Precision,
)
from repro_torch.quant.qint8 import (  # noqa: F401
    QMAX,
    SCALE_FLOOR,
    absmax_scale,
    dequantize_int8,
    quantize_int8,
    quantize_q8,
)
from repro_torch.quant.calibrate import (  # noqa: F401
    absmax_observer,
    percentile_observer,
    quantize_tensor,
    quantize_weights,
)

__all__ = [
    "Precision",
    "QUANT_MODES",
    "NOMINAL_OPERAND_BYTES",
    "INT8_OPERAND_BYTES",
    "QMAX",
    "SCALE_FLOOR",
    "absmax_scale",
    "quantize_q8",
    "quantize_int8",
    "dequantize_int8",
    "absmax_observer",
    "percentile_observer",
    "quantize_tensor",
    "quantize_weights",
]
