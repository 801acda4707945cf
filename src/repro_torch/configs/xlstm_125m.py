"""xLSTM-125M: sLSTM + mLSTM blocks, no FFN (d_ff=0). [arXiv:2405.04517]

sLSTM at layers {1, 7} (~7:1 mLSTM:sLSTM), mLSTM elsewhere, in the
stabilised parallel formulation. 4 heads are the mLSTM memory heads.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304, slstm_at=(1, 7),
    citation="arXiv:2405.04517",
)
