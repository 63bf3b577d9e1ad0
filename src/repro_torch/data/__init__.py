from repro_torch.data.pipeline import (  # noqa: F401
    DcnnBatches,
    TokenBatches,
    VolumeBatches,
)
