"""Model zoo of the port: the dense family, as plain functions on tensors."""
from .lm import decode_step, init_cache, init_params, prefill

__all__ = ["init_params", "init_cache", "prefill", "decode_step"]
