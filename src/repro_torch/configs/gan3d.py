"""3D-GAN generator (paper benchmark #3, 3D).  [NeurIPS'16 Wu et al.]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(name="3d-gan", family="dcnn", dcnn="3d_gan",
                     dcnn_z=200, dcnn_batch=32)
