"""MusicGen-medium decoder backbone over EnCodec tokens. [arXiv:2306.05284]

Backbone only: the EnCodec frontend is a stub; input_specs() provides the
4 codebook token streams; embeddings are summed (delay pattern collapsed).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab=2048, n_codebooks=4,
    citation="arXiv:2306.05284",
)
