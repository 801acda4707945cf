"""Configuration dataclasses of the port (``repro.configs`` counterpart)."""
from repro_torch.configs.base import ProtocolConfig

__all__ = ["ProtocolConfig"]
