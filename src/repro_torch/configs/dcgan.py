"""DCGAN generator (paper benchmark #1, 2D).  [arXiv:1511.06434]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(name="dcgan", family="dcnn", dcnn="dcgan",
                     dcnn_z=100, dcnn_batch=64)
