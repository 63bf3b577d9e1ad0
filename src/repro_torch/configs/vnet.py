"""V-Net volumetric segmenter (paper benchmark #4, 3D).
[arXiv:1606.04797]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(name="v-net", family="dcnn", dcnn="v_net",
                     dcnn_batch=4)
