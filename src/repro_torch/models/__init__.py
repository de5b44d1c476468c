"""Model zoo of the port: the dense family, as plain functions on tensors."""
from .lm import (commit_verify, decode_step, init_cache, init_paged_cache, init_params,
                 paged_insert, prefill, stack_verify_caches, tree_relocate, verify_hidden,
                 verify_step)

__all__ = ["init_params", "init_cache", "init_paged_cache", "prefill", "paged_insert",
           "decode_step", "verify_hidden", "verify_step", "stack_verify_caches",
           "commit_verify", "tree_relocate"]
