"""--arch registry: id -> (full config, reduced smoke config).

Holds only the architectures the port runs; the others wait for their
slices (ROADMAP.md)."""
from __future__ import annotations

from . import qwen2_1_5b
from .base import ModelConfig

_MODULES = {
    "qwen2-1.5b": qwen2_1_5b,
}

ARCH_IDS = list(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    return _MODULES[arch_id].CONFIG


def get_reduced(arch_id: str) -> ModelConfig:
    return _MODULES[arch_id].reduced()
