"""minitron-8b [dense], pruned nemotron (squared-ReLU, non-gated).
[arXiv:2407.14679]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=16384,
    vocab=256000, gated_mlp=False, mlp_activation="relu2", head_dim=128,
    rope_theta=1e4, fsdp=True,
)
