"""qwen2-vl-2b [vlm]: M-RoPE, dynamic-resolution vision frontend
stubbed (precomputed patch embeddings per the brief).  [arXiv:2409.12191]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_ff=8960,
    vocab=151936, gated_mlp=True, mlp_activation="silu", head_dim=128,
    mrope=True, mrope_sections=(16, 24, 24), rope_theta=1e6,
    tie_embeddings=True,
)
