"""The engine, the layer algebra and the tile planner of the port, behind
the JAX package's public names (``repro.core``).

One configured ``UniformEngine`` runs every conv and deconv layer of 2D
and 3D DCNNs on the hand-written Hopper kernels (method ``"pallas"``) or
on a reference lowering; ``compile_network`` turns a layer chain or graph
into a callable and its per-layer schedule; ``deconv_nd``/``conv_nd`` are
thin wrappers over memoized default engines.  The submodules hold the
paper's models: ``networks`` (the four benchmarks), ``sparsity`` (Fig. 1),
``tiling`` (Table II, Fig. 6a and the Hopper planner) and ``comparison``
(Fig. 7).  ``MeshPolicy`` and ``shard_batch`` partition compiled
schedules over a ``repro_torch.sharding.mesh.Mesh``.

Importing this package neither builds nor loads the CUDA library; the
first kernel launch does.
"""

from repro_torch.core.functional import (  # noqa: F401
    METHODS,
    PALLAS_KNOBS,
    canon_padding,
    deconv_iom,
    deconv_iom_phase,
    deconv_macs,
    deconv_nd,
    deconv_oom,
    deconv_output_shape,
    deconv_xla,
    insertion_sparsity,
    phase_kernels,
    pop_pallas_knobs,
    valid_mac_fraction,
    zero_insert,
)
from repro_torch.core.engine import (  # noqa: F401
    CONV_METHODS,
    EngineConfig,
    EngineError,
    LayerSchedule,
    MeshPolicy,
    ScheduleError,
    ScheduleReport,
    UniformEngine,
    VmemBudgetError,
    as_engine,
    compile_network,
    conv_nd,
    conv_output_shape,
    default_engine,
    init_network_weights,
    shard_batch,
    uniform_conv_method,
)
from repro_torch.core.networks import UniformLayer  # noqa: F401
# the engine's numeric policy, re-exported so engine users reach it
# without importing repro_torch.quant
from repro_torch.quant.precision import Precision  # noqa: F401
from repro_torch.core import (  # noqa: F401,E402
    comparison,
    networks,
    sparsity,
    tiling,
)
