"""Serving substrate of the port: PIM weight conversion, sampled decoding, the
fixed-batch engine and the continuous-batching engine over a paged cache with
its prefix cache."""
from .engine import (CapturedSteps, ChunkState, ContinuousBatchingEngine, DecodeState,
                     Request, ServingEngine, admit_cached, admit_miss, admit_prefill,
                     decode_and_emit, decode_chunk_step, mask_after_stop, pim_bytes,
                     quantize_tree, sample_logits, tail_verify)
from .prefix import PagePool, PrefixTrie, chunk_keys, extras_fingerprint
from .resilience import RequestRecord, ServeReport
from .sampling import (TAG_TOKEN, TAG_WINDOW, draw_keys, fold_in, prng_key,
                       sample_rows, warp_logits)

__all__ = ["CapturedSteps", "ChunkState", "ContinuousBatchingEngine", "DecodeState",
           "PagePool", "PrefixTrie", "Request", "RequestRecord", "ServeReport",
           "ServingEngine", "TAG_TOKEN", "TAG_WINDOW", "admit_cached", "admit_miss",
           "admit_prefill", "chunk_keys", "decode_and_emit", "decode_chunk_step", "draw_keys",
           "extras_fingerprint", "fold_in", "mask_after_stop", "pim_bytes", "prng_key",
           "quantize_tree", "sample_logits", "sample_rows", "tail_verify", "warp_logits"]
