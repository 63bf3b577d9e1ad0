"""Deconv kernel subsystem: the op on the hand kernel, its reference
lowering and oracle, and the planner's names (the JAX package's public
surface of ``repro.kernels.deconv``)."""
from repro_torch.core.tiling import (  # noqa: F401
    DeconvTilePlan,
    plan_uniform_tiles,
)
from repro_torch.kernels.deconv.ops import deconv  # noqa: F401
from repro_torch.kernels.deconv.ref import (  # noqa: F401
    deconv_loop_oracle,
    deconv_reference,
)
