"""llama3.2-1b [dense], GQA kv=8.  [hf:meta-llama/Llama-3.2-1B]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8, d_ff=8192,
    vocab=128256, gated_mlp=True, mlp_activation="silu", rope_theta=5e5,
    tie_embeddings=True,
)
