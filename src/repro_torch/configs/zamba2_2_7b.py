"""zamba2-2.7b [hybrid]: Mamba2 blocks + one shared attention block
applied every 6 layers.  [arXiv:2411.15242]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10240,
    vocab=32000, ssm_block="mamba2", ssm_state=64, ssm_chunk=256,
    attn_every=6, gated_mlp=True, mlp_activation="silu",
    long_context_ok=True,
)
