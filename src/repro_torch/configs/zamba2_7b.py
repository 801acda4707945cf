"""Zamba2-7B: Mamba2 backbone + shared attention blocks. [arXiv:2411.15242]

81 Mamba2 layers; one *shared-weight* attention+MLP block applied after
every 6 Mamba2 layers (13 insertions). The released model alternates two
shared blocks with LoRA adapters; simplified to one, as the reference's
config is.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab=32000,
    ssm=SSMConfig(d_state=64, n_groups=1, d_conv=4, expand=2, headdim=64),
    attn_every=6,
    citation="arXiv:2411.15242",
)
