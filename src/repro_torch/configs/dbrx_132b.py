"""dbrx-132b [moe]: 16 experts top-4, fine-grained.
[hf:databricks/dbrx-base]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=10752,
    vocab=100352, gated_mlp=True, mlp_activation="silu",
    n_experts=16, top_k=4,
    rope_theta=5e5, fsdp=True, opt_state_bits=8,
    moe_impl="shardmap", moe_groups=4, remat_segments=8,
)
