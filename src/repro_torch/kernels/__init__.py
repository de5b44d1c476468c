"""Hand-written CUDA kernels of the port, each beside its plain version.

  pim_matvec       — decode-shaped (M<=8) GEMV on quantized weights, fused epilogue
  pim_matmul       — the same contract for any M
  bitplane_matmul  — the bit-plane-decomposed matmul (PIM-semantic form)
  fold_reduce      — the OpMux halve-and-add fold of the last axis
  flash_attn       — online-softmax attention (flash_attention on (BH, S, D),
                     flash_attention_gqa on the model's (B, S, KV, G, D)); the
                     model's prefill over more than 8,192 keys runs it
  epilogue         — the shared epilogue (scale/bias/activation/residual)
  ops              — public entry points;  ref — plain-torch oracles

A kernel builds at its first launch on a CUDA tensor (``build.py``); on CPU
tensors the wrappers run the plain versions, which is what the CPU tests
exercise.
"""
from . import ref
from .bitplane import bitplane_matmul, bitplane_matmul_plain
from .epilogue import ACTIVATIONS, apply_epilogue
from .flash_attn import flash_attention, flash_attention_gqa, flash_attention_plain
from .fold_reduce import fold_reduce, fold_reduce_plain
from .ops import fold_sum, pim_dense, pim_dense_bitplane, pim_matvec_dense, quantize_for_pim
from .pim_matmul import pim_matmul, pim_matmul_plain
from .pim_matvec import MAX_M, pim_matvec, pim_matvec_plain

__all__ = ["ACTIVATIONS", "apply_epilogue", "MAX_M", "pim_matvec",
           "pim_matvec_plain", "pim_matmul", "pim_matmul_plain", "bitplane_matmul",
           "bitplane_matmul_plain", "fold_reduce", "fold_reduce_plain", "ref",
           "quantize_for_pim", "pim_dense", "pim_matvec_dense", "pim_dense_bitplane",
           "fold_sum", "flash_attention", "flash_attention_gqa", "flash_attention_plain"]
