"""PiCaSO instruction-set: FA/S op-codes (Table I) and the Booth Op-Encoder (Table II).

Twin of ``repro.core.isa``.  The bit-serial ALU is a Full-Adder/Subtractor
(FA/S) with four op-codes.  The Op-Encoder sits in front of the FA/S and
translates a 3-bit *configuration* plus the current Booth bit-pair
``(y_i, y_{i-1})`` of the multiplier into an FA/S op-code, exactly per
Table II of the paper.  Op-code tensors are int32 on the device of the
bit-pairs they decode.
"""
from __future__ import annotations

import enum

import torch


class OpCode(enum.IntEnum):
    """FA/S op-codes (paper Table I)."""

    ADD = 0  # SUM = X + Y           (full adder)
    SUB = 1  # SUM = X - Y           (full adder with borrow logic)
    CPX = 2  # SUM = X               (copy operand X)
    CPY = 3  # SUM = Y               (copy operand Y)


class EncoderConf(enum.IntEnum):
    """Op-Encoder configurations (paper Table II, 'Conf' column)."""

    REQ_ADD = 0b000  # request ADD unconditionally
    SEL_X = 0b001    # select X operand (CPX)
    SEL_Y = 0b010    # select Y operand (CPY)
    REQ_SUB = 0b011  # request SUB unconditionally
    BOOTH = 0b100    # 1xx: decode from the Booth bit-pair YX


def booth_decode(y_pair: torch.Tensor) -> torch.Tensor:
    """Decode Booth radix-2 bit-pairs into FA/S op-codes (Table II, rows 1xx).

    ``y_pair`` holds ``2*y_i + y_{i-1}`` per lane:
      00 -> CPX (NOP: keep accumulator) ; 01 -> ADD (+Y) ;
      10 -> SUB (-Y)                    ; 11 -> CPX (NOP).
    """
    y_pair = torch.as_tensor(y_pair)
    table = torch.tensor([OpCode.CPX, OpCode.ADD, OpCode.SUB, OpCode.CPX],
                         dtype=torch.int32, device=y_pair.device)
    return table[y_pair.long()]


def encode(conf: int, y_pair: torch.Tensor) -> torch.Tensor:
    """Full Op-Encoder: static configuration -> per-lane FA/S op-code array."""
    y_pair = torch.as_tensor(y_pair)
    if conf == EncoderConf.REQ_ADD:
        code = OpCode.ADD
    elif conf == EncoderConf.SEL_X:
        code = OpCode.CPX
    elif conf == EncoderConf.SEL_Y:
        code = OpCode.CPY
    elif conf == EncoderConf.REQ_SUB:
        code = OpCode.SUB
    elif conf & 0b100:
        return booth_decode(y_pair)
    else:  # pragma: no cover - exhaustive above
        raise ValueError(f"unknown Op-Encoder configuration {conf:#05b}")
    return torch.full(y_pair.shape, int(code), dtype=torch.int32, device=y_pair.device)
