"""Bit-serial FA/S ALU (paper Fig 1(b), Table I).

Twin of ``repro.core.alu``.  The ALU processes one operand bit per step; a
carry flip-flop holds the running carry/borrow between steps, exactly like
the hardware.  All PEs (lanes) execute in SIMD, but the Op-Encoder may give
each lane its own op-code (Booth's algorithm uses per-lane multiplier bits),
so the op-code is a per-lane tensor.  The JAX package scans the bit columns;
here a loop runs over them, least significant first, the carry held per
lane, on the device of the operands.

Functional contract (validated in tests/test_torch_core_bits.py):
  ADD: SUM = X + Y  (mod 2**width, two's complement)
  SUB: SUM = X - Y
  CPX: SUM = X
  CPY: SUM = Y
"""
from __future__ import annotations

import torch

from .isa import OpCode


def serial_alu(
    x_bits: torch.Tensor, y_bits: torch.Tensor, op: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the bit-serial FA/S over full operands.

    Args:
      x_bits, y_bits: ``(lanes, width)`` uint8 bit-planes, LSB first.
      op: ``(lanes,)`` int32 FA/S op-codes.

    Returns:
      ``(sum_bits, carry_out)`` with ``sum_bits`` of shape ``(lanes, width)``.
    """
    op = torch.as_tensor(op, device=x_bits.device).to(torch.int32)
    sub = op == OpCode.SUB
    cpx = op == OpCode.CPX
    cpy = op == OpCode.CPY
    copy = cpx | cpy
    carry = sub.to(torch.uint8)  # SUB lanes start with carry=1 (borrow via ~Y + 1)
    cols = []
    for i in range(x_bits.shape[1]):
        x, y = x_bits[:, i], y_bits[:, i]  # each (lanes,) uint8
        y_eff = torch.where(sub, 1 - y, y)
        s_fa = x ^ y_eff ^ carry
        c_fa = (x & y_eff) | (carry & (x ^ y_eff))
        cols.append(torch.where(cpx, x, torch.where(cpy, y, s_fa)))
        carry = torch.where(copy, carry, c_fa)
    return torch.stack(cols, dim=1), carry


def alu_cycles(width: int, cycles_per_bit: int = 2) -> int:
    """Cycle cost of one serial ALU pass.

    PiCaSO needs 2 cycles per bit (read + write of the register file through a
    single port pair); hence ADD/SUB latency ``2N`` in paper Table V.
    """
    return cycles_per_bit * width
