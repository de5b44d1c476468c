"""Public entry points of the PIM kernels (twin of ``repro.kernels.ops``):
quantize a weight, then run a quantized dense layer through ``pim_matmul``
(any M), ``pim_matvec`` (M <= 8) or, in the PIM-semantic form, bit-plane by
bit-plane through ``bitplane_matmul``; and the OpMux fold ``fold_sum``.

The wrappers pick kernel or plain version from the tensors' device (CUDA:
the kernel; CPU: the plain version), so these take no interpret switch.
"""
from __future__ import annotations

import torch

from repro_torch.quant import QuantizedTensor, pack_int4, quantize_symmetric, to_bitplanes

from .bitplane import bitplane_matmul
from .fold_reduce import fold_reduce
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


def pim_dense_bitplane(x: torch.Tensor, w: torch.Tensor, bits: int = 4, *, bias=None,
                       activation: str = "none", residual=None) -> torch.Tensor:
    """PIM-semantic path: quantize + bit-plane decompose + plane-wise matmul,
    epilogue fused."""
    q = quantize_symmetric(w, bits=bits, axis=0)
    planes = to_bitplanes(q.codes, bits)
    return bitplane_matmul(x, planes, q.scale, bias=bias, activation=activation,
                           residual=residual)


def fold_sum(x: torch.Tensor) -> torch.Tensor:
    """OpMux-fold reduction of the last axis (power-of-two length)."""
    return fold_reduce(x)


__all__ = ["quantize_for_pim", "pim_dense", "pim_matvec_dense", "pim_dense_bitplane",
           "fold_sum"]
