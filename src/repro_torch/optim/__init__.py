from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig,
    AdamWState,
    QTensor,
    adamw_init,
    adamw_update,
)
