"""Public entry points of the packed PIM kernels (twin of the packed half of
``repro.kernels.ops``): quantize a weight, then run a quantized dense layer
through ``pim_matmul`` (any M) or ``pim_matvec`` (M <= 8).

The wrappers pick kernel or plain version from the tensors' device (CUDA:
the kernel; CPU: the plain version), so these take no interpret switch.
"""
from __future__ import annotations

import torch

from repro_torch.quant import QuantizedTensor, pack_int4, quantize_symmetric

from .pim_matmul import pim_matmul
from .pim_matvec import pim_matvec


def quantize_for_pim(w: torch.Tensor, bits: int = 8) -> QuantizedTensor:
    """Quantize a (K, N) weight for PIM-mode matmul (packs nibbles for int4)."""
    q = quantize_symmetric(w, bits=bits, axis=0)
    if bits == 4:
        return QuantizedTensor(pack_int4(q.codes), q.scale, 4, packed=True)
    return q


def pim_dense(x: torch.Tensor, q: QuantizedTensor, *, bias=None,
              activation: str = "none", residual=None) -> torch.Tensor:
    """Quantized dense layer: x @ dequant(q), epilogue fused.  Accepts
    int4-packed or int8."""
    return pim_matmul(x, q.codes, q.scale, bits=q.bits, bias=bias,
                      activation=activation, residual=residual)


def pim_matvec_dense(x: torch.Tensor, q: QuantizedTensor, *, bias=None,
                     activation: str = "none", residual=None) -> torch.Tensor:
    """Decode-shaped (M<=8) quantized matvec with the fused epilogue."""
    return pim_matvec(x, q.codes, q.scale, bits=q.bits, bias=bias,
                      activation=activation, residual=residual)


__all__ = ["quantize_for_pim", "pim_dense", "pim_matvec_dense"]
