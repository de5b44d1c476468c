"""--arch registry: id -> (full config, reduced smoke config).

Holds the architectures the port runs: the dense family, the mixtures of
experts deepseek-v2-lite-16b (MLA attention) and moonshot-v1-16b-a3b (GQA
attention), the encoder-decoder seamless-m4t-medium, the vision-language
llama-3.2-vision-90b and the attention-free falcon-mamba-7b (Mamba1), in
the JAX package's order.  The hybrid family waits for its slice
(ROADMAP.md), and ``get_config`` of its id raises ``KeyError``."""
from __future__ import annotations

from . import (deepseek_v2_lite, falcon_mamba_7b, llama3_2_3b, llama3_2_vision_90b,
               moonshot_16b_a3b, qwen2_1_5b, seamless_m4t_medium, starcoder2_7b, starcoder2_15b)
from .base import ModelConfig

_MODULES = {
    "qwen2-1.5b": qwen2_1_5b,
    "starcoder2-7b": starcoder2_7b,
    "llama3.2-3b": llama3_2_3b,
    "starcoder2-15b": starcoder2_15b,
    "deepseek-v2-lite-16b": deepseek_v2_lite,
    "moonshot-v1-16b-a3b": moonshot_16b_a3b,
    "seamless-m4t-medium": seamless_m4t_medium,
    "llama-3.2-vision-90b": llama3_2_vision_90b,
    "falcon-mamba-7b": falcon_mamba_7b,
}

ARCH_IDS = list(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    return _MODULES[arch_id].CONFIG


def get_reduced(arch_id: str) -> ModelConfig:
    return _MODULES[arch_id].reduced()
