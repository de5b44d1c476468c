"""Model zoo of the port: the dense family, as plain functions on tensors."""
from .lm import (decode_step, init_cache, init_paged_cache, init_params, paged_insert,
                 prefill)

__all__ = ["init_params", "init_cache", "init_paged_cache", "prefill", "paged_insert",
           "decode_step"]
