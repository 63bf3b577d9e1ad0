"""GP-GAN blending generator (paper benchmark #2, 2D).
[arXiv:1703.07195]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(name="gp-gan", family="dcnn", dcnn="gp_gan",
                     dcnn_z=256, dcnn_batch=64)
