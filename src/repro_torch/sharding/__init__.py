"""Named mesh axes and their collectives, and the logical-axis
partitioning of the DCNN models over a mesh."""

from repro_torch.sharding.mesh import (  # noqa: F401
    Mesh,
    MeshError,
    all_gather,
    all_reduce,
    pmean,
)
from repro_torch.sharding.partition import (  # noqa: F401
    constrain,
    conv_weight_axes,
    logical_to_spec,
    mesh_axes,
)
