"""Serving substrate of the port: PIM weight conversion, sampled decoding, the
fixed-batch engine, and the continuous-batching engine over a paged cache with
its prefix cache, its resilience tier (``serving.resilience``, fault injection
in ``serving.chaos``) and the multi-replica router (``serving.router``).
Both engines speculate under ``speculate=SpecConfig(k=...)`` with n-gram
proposals, a tree of n-gram chains (``tree_fan=F``), or a draft model's
(``mode="draft"``, the engines' ``draft_cfg``/``draft_params``)
(``serving.speculative``; rejection-sampled verification in
``serving.sampling``)."""
from .chaos import ChaosConfig, ChunkFault, EngineCrash, FaultInjector, VirtualClock
from .engine import (CapturedSteps, ChunkState, ContinuousBatchingEngine, DecodeState,
                     Request, ServingEngine, admit_cached, admit_miss, admit_prefill,
                     decode_and_emit, decode_chunk_step, mask_after_stop, pim_bytes,
                     quantize_tree, sample_logits, tail_verify)
from .prefix import PagePool, PrefixTrie, chunk_keys, extras_fingerprint
from .resilience import (LadderConfig, RequestRecord, ResiliencePolicy, ServeReport,
                         ServeSnapshot, ServingSupervisor, load_snapshot, save_snapshot)
from .router import ReplicaRouter, RouterReport
from .sampling import (TAG_TOKEN, TAG_WINDOW, acceptance_probs, draw_keys, fold_in, prng_key,
                       rejection_sample, residual_dist, sample_rows, split, tree_reject_sample,
                       typical_accept_sample, warp_logits)
from .speculative import (SpecConfig, SpecState, draft_propose, greedy_tree_accept, propose_ngram,
                          propose_ngram_tree, spec_chunk_step, spec_window)

__all__ = ["CapturedSteps", "ChaosConfig", "ChunkFault", "ChunkState",
           "ContinuousBatchingEngine", "DecodeState", "EngineCrash", "FaultInjector",
           "LadderConfig", "PagePool", "PrefixTrie", "ReplicaRouter", "Request",
           "RequestRecord", "ResiliencePolicy", "RouterReport", "ServeReport", "ServeSnapshot",
           "ServingEngine", "ServingSupervisor", "SpecConfig", "SpecState", "TAG_TOKEN",
           "TAG_WINDOW", "VirtualClock", "acceptance_probs", "admit_cached", "admit_miss",
           "admit_prefill", "chunk_keys", "decode_and_emit", "decode_chunk_step",
           "draft_propose", "draw_keys", "greedy_tree_accept",
           "extras_fingerprint", "fold_in", "load_snapshot", "mask_after_stop", "pim_bytes",
           "prng_key", "propose_ngram", "propose_ngram_tree", "quantize_tree",
           "rejection_sample", "residual_dist",
           "sample_logits", "sample_rows", "save_snapshot", "spec_chunk_step", "spec_window",
           "split", "tail_verify", "tree_reject_sample", "typical_accept_sample", "warp_logits"]
