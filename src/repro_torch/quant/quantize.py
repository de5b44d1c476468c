"""Symmetric per-channel weight quantization, int4 nibble packing and
bit-plane decomposition.

Twin of ``repro.quant.quantize``: the codes and planes are equal to the JAX
package's bit for bit (both round half to even), so a tree quantized by
either package decodes identically in the other.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class QuantizedTensor:
    """Weights as stored in 'PIM mode': integer codes + per-channel scale.

    codes: int8 codes in [-2^(bits-1), 2^(bits-1)-1], shape = original shape
           (or nibble-packed along axis 0 when ``packed`` is True, bits=4).
    scale: f32, broadcastable along the quantization axis.
    """

    codes: torch.Tensor
    scale: torch.Tensor
    bits: int
    packed: bool = False

    @property
    def shape(self) -> tuple:
        """The shape of the weight the codes stand for."""
        if self.packed:
            return (2 * self.codes.shape[0],) + tuple(self.codes.shape[1:])
        return tuple(self.codes.shape)


def quantize_symmetric(w: torch.Tensor, bits: int = 8, axis: int = 0) -> QuantizedTensor:
    """Per-output-channel symmetric quantization (axis = reduction axis).

    The scale is chosen per channel of the *non*-reduction dims so the matmul
    can rescale once per output column.
    """
    qmax = 2 ** (bits - 1) - 1
    amax = w.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(amax > 0, amax / qmax, 1.0).to(torch.float32)
    codes = torch.clamp(torch.round(w / scale), -qmax - 1, qmax).to(torch.int8)
    return QuantizedTensor(codes=codes, scale=scale, bits=bits)


def dequantize(q: QuantizedTensor) -> torch.Tensor:
    """The f32 weight the codes stand for: codes x scale."""
    codes = unpack_int4(q.codes) if q.packed else q.codes
    return codes.to(torch.float32) * q.scale


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """Pack int4 codes pairwise along axis 0: (K, ...) int8 -> (K//2, ...) int8.

    Row 2i goes to the low nibble, row 2i+1 to the high nibble.  K must be
    even — callers with an odd K pad one zero-code row first (that is what
    ``serving.quantize_tree`` does, flagging it with ``nibbles_odd``).
    """
    if codes.shape[0] % 2:
        raise ValueError(
            f"pack_int4 requires an even K, got K={codes.shape[0]}; "
            "pad one zero code row (see serving.quantize_tree)")
    lo = codes[0::2] & 0xF
    hi = codes[1::2] & 0xF
    return (lo | (hi << 4)).to(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`, with sign extension."""
    lo = ((packed & 0xF) ^ 8) - 8
    hi = (((packed >> 4) & 0xF) ^ 8) - 8
    k2 = packed.shape[0]
    out = torch.stack([lo, hi], dim=1).reshape((2 * k2,) + tuple(packed.shape[1:]))
    return out.to(torch.int8)


def to_bitplanes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Integer codes -> bit-planes, LSB first: int8 of shape ``(bits,) + codes.shape``.

    Two's complement: plane ``bits-1`` carries weight ``-2^(bits-1)``.  This is
    the *spatial* analogue of PiCaSO's bit-serial striped storage (§III-A).
    """
    shifts = torch.arange(bits, dtype=torch.int32, device=codes.device)
    shifts = shifts.reshape((bits,) + (1,) * codes.dim())
    return ((codes.to(torch.int32)[None] >> shifts) & 1).to(torch.int8)


def from_bitplanes(planes: torch.Tensor) -> torch.Tensor:
    """Bit-planes -> int32 codes (two's complement)."""
    bits = planes.shape[0]
    weights = 2 ** torch.arange(bits, dtype=torch.int32, device=planes.device)
    weights[bits - 1] = -weights[bits - 1]
    weights = weights.reshape((bits,) + (1,) * (planes.dim() - 1))
    return torch.sum(planes.to(torch.int32) * weights, dim=0, dtype=torch.int32)
