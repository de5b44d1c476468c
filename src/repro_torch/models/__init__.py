"""Model zoo of the port: the dense, moe, ssm, vlm and encdec families, as plain
functions on tensors."""
from .lm import (commit_verify, decode_step, encode, init_cache, init_paged_cache, init_params,
                 paged_insert, prefill, prefill_hidden, stack_verify_caches, tree_relocate,
                 verify_hidden, verify_step)

__all__ = ["init_params", "init_cache", "init_paged_cache", "prefill", "prefill_hidden",
           "paged_insert",
           "decode_step", "verify_hidden", "verify_step", "stack_verify_caches",
           "commit_verify", "tree_relocate", "encode"]
