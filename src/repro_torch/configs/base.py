"""The DCNN fields of the JAX package's ``ModelConfig``.

Field names and defaults are the reference's (``repro/configs/base.py``),
except ``dcnn_method``: the port's only engine method is ``"pallas"`` (the
hand kernels), where the JAX models default to ``"iom_phase"``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # "dcnn" (the LM families: item 15)
    master_dtype: str = "float32"
    dcnn: str = ""                    # dcgan | gp_gan | 3d_gan | v_net
    dcnn_z: int = 100
    dcnn_batch: int = 64
    dcnn_reduced: bool = False        # smoke: 1/8 channels, small volumes
    dcnn_method: str = "pallas"       # EngineConfig.method of the trainer

    def reduced(self) -> "ModelConfig":
        """Smoke-test configuration of the same family."""
        return dataclasses.replace(self, dcnn_batch=2, dcnn_reduced=True)
