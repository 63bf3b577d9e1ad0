"""snowflake arctic-480b [moe]: 128 experts top-2 + dense residual MLP.
[hf:Snowflake/snowflake-arctic-base]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=4864,
    vocab=32000, gated_mlp=True, mlp_activation="silu",
    n_experts=128, top_k=2, residual_mlp=True,
    rope_theta=1e4, fsdp=True, opt_state_bits=8, master_dtype="bfloat16",
    moe_impl="shardmap", moe_groups=4, remat_segments=7,
)
