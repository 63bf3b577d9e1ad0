"""xlstm-350m [ssm]: sLSTM + mLSTM blocks (xLSTM[7:1]-style mix).
[arXiv:2405.04517]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab=50304, ssm_block="xlstm", slstm_every=8, ssm_chunk=256,
    long_context_ok=True,
)
