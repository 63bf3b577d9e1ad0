from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig,
    AdamWState,
    QTensor,
    adamw_init,
    adamw_update,
)
from repro_torch.optim.schedule import cosine_schedule  # noqa: F401
from repro_torch.optim.compress import (  # noqa: F401
    dequantize_int8,
    psum_int8,
    psum_int8_tree,
    quantize_int8,
)
