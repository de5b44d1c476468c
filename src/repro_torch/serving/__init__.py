"""Serving substrate of the port: PIM weight conversion, sampled decoding, the
fixed-batch engine and the continuous-batching engine over a paged cache."""
from .engine import (CapturedSteps, ChunkState, ContinuousBatchingEngine, DecodeState,
                     Request, ServingEngine, admit_prefill, decode_and_emit,
                     decode_chunk_step, mask_after_stop, pim_bytes, quantize_tree,
                     sample_logits)
from .prefix import PagePool
from .resilience import RequestRecord, ServeReport
from .sampling import (TAG_TOKEN, TAG_WINDOW, draw_keys, fold_in, prng_key,
                       sample_rows, warp_logits)

__all__ = ["CapturedSteps", "ChunkState", "ContinuousBatchingEngine", "DecodeState",
           "PagePool", "Request", "RequestRecord", "ServeReport", "ServingEngine",
           "TAG_TOKEN", "TAG_WINDOW", "admit_prefill", "decode_and_emit",
           "decode_chunk_step", "draw_keys", "fold_in", "mask_after_stop", "pim_bytes",
           "prng_key", "quantize_tree", "sample_logits", "sample_rows", "warp_logits"]
