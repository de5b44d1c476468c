"""Architecture configs the port runs, and their registry."""
from .base import ModelConfig
from .registry import ARCH_IDS, get_config, get_reduced

__all__ = ["ModelConfig", "ARCH_IDS", "get_config", "get_reduced"]
