"""Configuration dataclasses and the architecture registry of the port
(``repro.configs`` counterpart).

``get_config(arch_id)`` returns the full config, ``get_config(arch_id,
reduced=True)`` the CPU smoke variant. The registry is the reference's
catalogue of ten, in its order: the dense ``mistral-large-123b``,
``starcoder2-15b``, ``minitron-8b`` and ``glm4-9b``; the vlm
``llava-next-mistral-7b`` and the audio ``musicgen-medium`` (dense blocks
behind a patch-embedding projector or summed codebook embeddings); the moe
``qwen3-moe-30b-a3b`` and ``phi3.5-moe-42b-a6.6b``; the hybrid (Mamba2
plus one shared attention block) ``zamba2-7b``; and the ssm (xLSTM)
``xlstm-125m``. Beside it, the port's own configurations, which
``get_config`` also resolves and ``ARCHS`` does not list (the reference
has no counterpart): ``zamba2-7b-instruct``, Zamba2 as published
(``Zamba2Config``). An id outside both raises ``KeyError``.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (SHAPES, ModelConfig, ProtocolConfig,
                                      ShapeConfig)

_ARCH_MODULES: Dict[str, str] = {
    "mistral-large-123b": "repro_torch.configs.mistral_large_123b",
    "musicgen-medium": "repro_torch.configs.musicgen_medium",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "llava-next-mistral-7b": "repro_torch.configs.llava_next_mistral_7b",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi35_moe_42b_a66b",
    "starcoder2-15b": "repro_torch.configs.starcoder2_15b",
    "minitron-8b": "repro_torch.configs.minitron_8b",
    "glm4-9b": "repro_torch.configs.glm4_9b",
}

ARCHS: List[str] = list(_ARCH_MODULES)

#: configurations of the port alone, outside the reference's catalogue
_PORT_MODULES: Dict[str, str] = {
    "zamba2-7b-instruct": "repro_torch.configs.zamba2_7b_instruct",
}


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    module = _ARCH_MODULES.get(arch) or _PORT_MODULES.get(arch)
    if module is None:
        raise KeyError(f"unknown arch {arch!r}; available: "
                       f"{ARCHS + list(_PORT_MODULES)}")
    cfg: ModelConfig = importlib.import_module(module).CONFIG
    return cfg.reduced() if reduced else cfg


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


__all__ = ["ModelConfig", "ProtocolConfig", "ShapeConfig", "SHAPES",
           "ARCHS", "get_config", "get_shape"]
