"""Bit-plane <-> integer conversions and the parallel-to-serial corner turn.

Twin of ``repro.core.bitops``.  PiCaSO stores operands *bit-serially*: an
N-bit operand occupies N consecutive wordlines of a PE's register-file
column (paper §III-A).  In the functional simulator, the register file of a
PE array is a ``uint8`` tensor of shape ``(num_pes, rf_depth)`` whose
entries are single bits.  These helpers convert between ordinary integer
tensors and striped bit-plane storage, on the device of their input.

Two's-complement semantics throughout: ``width``-bit operands represent values
in ``[-2**(width-1), 2**(width-1))``.  Integers pass through int32 lanes, as
in the JAX package: ``to_bits`` wraps its input to int32 first, and
``from_bits`` returns the int32 value modulo 2**32.
"""
from __future__ import annotations

import torch


def to_bits(x, width: int) -> torch.Tensor:
    """Integer tensor -> bit-planes, LSB first.  Output shape ``x.shape + (width,)``."""
    x = torch.as_tensor(x).to(torch.int32)  # wraps values past int32, as JAX does
    shifts = torch.arange(width, dtype=torch.int32, device=x.device)
    return ((x[..., None] >> shifts) & 1).to(torch.uint8)


def from_bits(bits: torch.Tensor, signed: bool = True) -> torch.Tensor:
    """Bit-planes (LSB first, last axis) -> int32, two's complement if signed."""
    width = bits.shape[-1]
    if width > 32:
        raise ValueError("from_bits supports widths up to 32 (int32 lanes)")
    weights = torch.ones(width, dtype=torch.int64, device=bits.device) << torch.arange(
        width, dtype=torch.int64, device=bits.device)
    if signed and width > 0:
        weights[-1] = -weights[-1]
    # The sum in int64, then wrapped to int32 explicitly: two's-complement
    # semantics for width <= 32, with no reliance on int32 overflow.
    total = (bits.to(torch.int64) * weights).sum(-1)
    return (torch.remainder(total + (1 << 31), 1 << 32) - (1 << 31)).to(torch.int32)


def sign_extend_bits(bits: torch.Tensor, width: int) -> torch.Tensor:
    """Extend bit-plane operands (last axis) to ``width`` bits, two's complement."""
    cur = bits.shape[-1]
    if cur >= width:
        return bits[..., :width]
    msb = bits[..., -1:]
    pad = msb.expand(bits.shape[:-1] + (width - cur,))
    return torch.cat([bits, pad], dim=-1)


def corner_turn(words, width: int) -> torch.Tensor:
    """Parallel-to-serial corner turn (paper §III-A).

    Takes parallel data ``words`` of shape ``(num_pes,)`` (one word per PE,
    as read from DRAM/external I/O) and produces the striped column layout
    ``(num_pes, width)`` written into the BRAM register files.
    """
    return to_bits(words, width)


def corner_turn_inverse(striped: torch.Tensor, signed: bool = True) -> torch.Tensor:
    """Serial-to-parallel corner turn: gather a striped column back to words."""
    return from_bits(striped, signed=signed)
