"""LLaVA-NeXT (Mistral-7B backbone), anyres tiling. [hf:llava-hf/llava-v1.6-mistral-7b-hf]

Backbone only: vision tower + projector are stubs; input_specs() provides
576 precomputed patch embeddings prepended to the text tokens.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000, n_patches=576, rope_theta=1e6,
    citation="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
