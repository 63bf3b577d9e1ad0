"""Model configs and the four assigned input shapes.

Field names and defaults are the JAX package's ``repro/configs/base.py``,
so a config crosses between the packages unchanged, except
``dcnn_method``: the port's only engine method is ``"pallas"`` (the hand
kernels), where the JAX models default to ``"iom_phase"``, and the
reference's ``dcnn_spatial_shard``, which nothing in the port reads.
Each block's comment names the ROADMAP item 15 slice that reads it; a
block marked for a later slice is carried so that configs cross
unchanged, and changes nothing in the port until that slice lands.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense|moe|ssm|hybrid|encdec|vlm|dcnn
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab: int = 0
    head_dim: int = 0                 # 0 -> d_model // n_heads
    # MLP
    gated_mlp: bool = True
    mlp_activation: str = "silu"      # silu | gelu | relu2
    # MoE (read by the serving path; router_aux_weight by the LM
    # training slice, 15.5)
    n_experts: int = 0
    top_k: int = 0
    residual_mlp: bool = False        # arctic: dense MLP parallel to MoE
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # SSM (xLSTM, Mamba-2; read by the serving path)
    ssm_block: str = ""               # "xlstm" | "mamba2"
    ssm_state: int = 0
    slstm_every: int = 0              # xlstm: every Nth layer is sLSTM
    ssm_chunk: int = 256
    # hybrid (zamba2; read by the serving path)
    attn_every: int = 0               # shared attention block every N layers
    # enc-dec (whisper; read by the serving path)
    n_enc_layers: int = 0
    enc_seq: int = 1500               # stub frontend frames
    # vlm (qwen2-vl; read by the serving path)
    mrope: bool = False
    mrope_sections: tuple[int, ...] = (16, 24, 24)
    # positions / norm (read by the serving path)
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # distribution (remat, opt_state_bits and master_dtype read by the
    # LM training slice, 15.5; fsdp and scan_layers by the dry-run and
    # partitioning slice, 15.6)
    fsdp: bool = False
    remat: bool = True
    scan_layers: bool = True
    opt_state_bits: int = 32          # 8 -> quantized Adam moments
    master_dtype: str = "float32"     # bfloat16 for arctic (memory)
    # hill-climb levers of the reference (defaults: the paper's baseline;
    # remat_policy, xent_chunk and remat_segments read by the LM training
    # slice, whose remat_policy "save_outs" waits for 15.6 with moe_impl,
    # kv_seq_shard and moe_groups)
    remat_policy: str = "nothing"
    moe_impl: str = "dense_scatter"
    xent_chunk: int = 8192            # CE token-chunk
    kv_seq_shard: bool = False        # decode: shard the KV cache's seq dim
    moe_groups: int = 1               # MoE dispatch in G token groups
    remat_segments: int = 0           # >0: save h every L/segments layers
    # dcnn
    dcnn: str = ""                    # dcgan | gp_gan | 3d_gan | v_net
    dcnn_z: int = 100
    dcnn_batch: int = 64
    dcnn_reduced: bool = False        # smoke: 1/8 channels, small volumes
    dcnn_method: str = "pallas"       # EngineConfig.method of the trainer
    # attention (causal read by the serving slice; long_context_ok by
    # shape_applicable)
    causal: bool = True
    long_context_ok: bool = False     # sub-quadratic (ssm/hybrid)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    def reduced(self) -> "ModelConfig":
        """Smoke-test configuration of the same family."""
        if self.family == "dcnn":
            return dataclasses.replace(self, dcnn_batch=2, dcnn_reduced=True)
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 4),
            n_enc_layers=min(self.n_enc_layers, 2),
            d_model=128,
            n_heads=min(self.n_heads, 4),
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=32,
            d_ff=256 if self.d_ff else 0,
            vocab=256,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_chunk=16,
            attn_every=2 if self.attn_every else 0,
            slstm_every=2 if self.slstm_every else 0,
            enc_seq=16,
            mrope_sections=(4, 6, 6) if self.mrope else self.mrope_sections,
            fsdp=False,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str                         # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Is this (arch x shape) cell runnable?  (long_500k needs
    sub-quadratic attention.)"""
    if cfg.family == "dcnn":
        return (shape.kind == "train", "DCNN configs train only")
    if shape.name == "long_500k" and not cfg.long_context_ok:
        return (False, "pure full-attention arch: 524k dense-attention decode "
                       "is out of memory/compute budget by design")
    return (True, "")
