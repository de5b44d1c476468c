"""Serving substrate of the port: PIM weight conversion, sampled decoding and
the fixed-batch engine."""
from .engine import (DecodeState, ServingEngine, decode_and_emit, mask_after_stop,
                     pim_bytes, quantize_tree, sample_logits)
from .sampling import (TAG_TOKEN, TAG_WINDOW, draw_keys, fold_in, prng_key,
                       sample_rows, warp_logits)

__all__ = ["DecodeState", "ServingEngine", "TAG_TOKEN", "TAG_WINDOW", "decode_and_emit",
           "draw_keys", "fold_in", "mask_after_stop", "pim_bytes", "prng_key",
           "quantize_tree", "sample_logits", "sample_rows", "warp_logits"]
