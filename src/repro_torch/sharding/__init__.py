"""Named mesh axes and their collectives (plain and autograd-aware), and
the logical-axis partitioning of the models' parameters over a mesh."""

from repro_torch.sharding.mesh import (  # noqa: F401
    Mesh,
    MeshError,
    all_gather,
    all_reduce,
    axis_index,
    collective_stats,
    copy_to,
    gather_from,
    pmean,
    reduce_from,
    reduce_scatter,
    reset_collective_stats,
    scale_grad,
)
from repro_torch.sharding.partition import (  # noqa: F401
    WS,
    block_index,
    constrain,
    conv_weight_axes,
    current_mesh,
    is_logical_leaf,
    local_block,
    logical_to_spec,
    mesh_axes,
    param_shardings,
    shard_tree,
    split_params,
    use_mesh,
)
