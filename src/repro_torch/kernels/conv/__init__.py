"""Conv kernel subsystem: the op on the hand kernel, its reference
lowering and oracle, and the planner's names (the JAX package's public
surface of ``repro.kernels.conv``)."""
from repro_torch.core.tiling import (  # noqa: F401
    DeconvTilePlan,
    plan_uniform_tiles,
)
from repro_torch.kernels.conv.ops import conv  # noqa: F401
from repro_torch.kernels.conv.ref import (  # noqa: F401
    conv_output_shape,
    conv_reference,
)
