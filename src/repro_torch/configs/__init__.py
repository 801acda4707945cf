"""Configuration dataclasses and the architecture registry of the port
(``repro.configs`` counterpart).

``get_config(arch_id)`` returns the full config, ``get_config(arch_id,
reduced=True)`` the CPU smoke variant. The registry holds the configs whose
path the port runs: the dense ``glm4-9b``, the ssm (xLSTM) ``xlstm-125m``,
the moe ``qwen3-moe-30b-a3b`` and the hybrid (Mamba2 plus one shared
attention block) ``zamba2-7b``. Any other id of the reference's catalogue
raises ``KeyError`` until it is ported (ROADMAP, queue A).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (SHAPES, ModelConfig, ProtocolConfig,
                                      ShapeConfig)

_ARCH_MODULES: Dict[str, str] = {
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
    "glm4-9b": "repro_torch.configs.glm4_9b",
}

ARCHS: List[str] = list(_ARCH_MODULES)


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"arch {arch!r} is not ported; available: {ARCHS}")
    cfg: ModelConfig = importlib.import_module(_ARCH_MODULES[arch]).CONFIG
    return cfg.reduced() if reduced else cfg


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


__all__ = ["ModelConfig", "ProtocolConfig", "ShapeConfig", "SHAPES",
           "ARCHS", "get_config", "get_shape"]
