"""granite-20b-code [dense], MQA kv=1 (gpt-bigcode lineage).
[arXiv:2405.04324]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1, d_ff=24576,
    vocab=49152, gated_mlp=False, mlp_activation="gelu", rope_theta=1e4,
    fsdp=True,
)
