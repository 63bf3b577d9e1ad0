"""stablelm-2-1.6b [dense].  [hf:stabilityai/stablelm-2-1_6b]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=5632,
    vocab=100352, gated_mlp=True, mlp_activation="silu", rope_theta=1e4,
)
