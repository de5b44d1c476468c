"""Booth radix-2 bit-serial multiplier (paper §III-B, Table II).

Twin of ``repro.core.booth``.  Classic serial/parallel Booth recoding as
implemented by the PiCaSO PE: a 2N-bit product register is updated over N
steps; at step ``i`` the Op-Encoder inspects the multiplier bit-pair
``(y_i, y_{i-1})`` and requests ADD (+M), SUB (-M) or CPX (NOP) of the
multiplicand ``M`` into the *upper half* of the product register, which is
then arithmetic-shifted right by one.  Each step is an ``N+1``-bit serial
ALU pass (2 cycles/bit), giving the paper's Table V latency ``2N^2 + 2N``.
The JAX package scans the multiplier's bits; here a loop runs over them.
"""
from __future__ import annotations

import torch

from .alu import serial_alu
from .bitops import from_bits, sign_extend_bits, to_bits
from .isa import booth_decode


def booth_multiply_bits(
    m_bits: torch.Tensor, y_bits: torch.Tensor
) -> torch.Tensor:
    """Multiply bit-plane operands.

    Args:
      m_bits: multiplicand, ``(lanes, N)`` uint8 LSB-first two's complement.
      y_bits: multiplier, ``(lanes, N)``.

    Returns:
      Product bit-planes ``(lanes, 2N)`` (exact signed product, two's compl.).
    """
    lanes, width = m_bits.shape
    m_ext = sign_extend_bits(m_bits, width + 1)  # (lanes, N+1)

    p = torch.zeros((lanes, 2 * width), dtype=torch.uint8, device=m_bits.device)
    y_prev = torch.zeros((lanes,), dtype=torch.uint8, device=m_bits.device)
    for i in range(y_bits.shape[1]):
        y_i = y_bits[:, i]
        op = booth_decode((2 * y_i + y_prev).to(torch.int32))  # (lanes,) FA/S op-codes
        hi = sign_extend_bits(p[:, width:], width + 1)  # (lanes, N+1)
        s, _ = serial_alu(hi, m_ext, op)  # (lanes, N+1)
        # Arithmetic shift right by 1: low half picks up s[0]; high half = s[1:].
        p = torch.cat([p[:, 1:width], s[:, :1], s[:, 1:]], dim=1)
        y_prev = y_i
    return p


def booth_multiply(x, y, width: int) -> torch.Tensor:
    """Integer-level wrapper: signed ``width``-bit multiply via the serial PE."""
    xb = to_bits(x, width)
    yb = to_bits(y, width)
    return from_bits(booth_multiply_bits(xb, yb), signed=True)


def booth_cycles(width: int) -> int:
    """Paper Table V: MULT latency (cycles) = 2N^2 + 2N."""
    return 2 * width * width + 2 * width


def booth_nop_fraction(y, width: int) -> torch.Tensor:
    """Fraction of Booth steps that are NOPs (bit-pairs 00/11), a 0-d float32.

    Paper §V-B: on average half of the intermediate steps are NOPs, which a
    controller-scheduled overlay can skip (custom designs mostly cannot).
    """
    yb = to_bits(y, width).to(torch.int32)
    prev = torch.cat([torch.zeros(yb.shape[:-1] + (1,), dtype=torch.int32, device=yb.device),
                      yb[..., :-1]], dim=-1)
    nop = (yb == prev).to(torch.float32)
    return nop.mean()
