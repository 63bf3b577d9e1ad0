"""whisper-tiny [audio]: enc-dec, conv frontend stubbed (precomputed
frame embeddings per the brief).  [arXiv:2212.04356]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="encdec",
    n_layers=4, n_enc_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab=51865, gated_mlp=False, mlp_activation="gelu",
    enc_seq=1500, rope_theta=1e4, tie_embeddings=True,
)
