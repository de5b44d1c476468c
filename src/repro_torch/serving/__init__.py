"""Serving substrate of the port: PIM weight conversion and the fixed-batch
greedy engine."""
from .engine import ServingEngine, mask_after_stop, pim_bytes, quantize_tree

__all__ = ["ServingEngine", "mask_after_stop", "pim_bytes", "quantize_tree"]
