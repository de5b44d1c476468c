"""Operand Multiplexer (OpMux) — zero-copy folding reduction (paper Fig 2, Table III).

Twin of ``repro.core.opmux``.  The OpMux selects the ALU's X and Y operands.
Besides the pass-through ``A-OP-B`` configuration, the ``A-FOLD-k``
configurations route *another PE's* bitline into the Y port, so a PE row can
be reduced (summed) in log2 steps without ever copying operands between
bitlines — the paper's key memory efficiency and accumulation-latency win.

Two fold families from Fig 2:
  pattern (a) "half" folds:      PE i receives PE (i + span)     (span halves)
  pattern (b) "adjacent" folds:  PE 2^k*i receives PE 2^k*i+2^(k-1)

For a 16-PE block, A-FOLD-1..4 are pattern (a) with span 8, 4, 2, 1; the
result accumulates in PE 0.
"""
from __future__ import annotations

import enum

import numpy as np
import torch

from .alu import serial_alu
from .isa import OpCode


class OpMuxConf(enum.IntEnum):
    """Table III configuration codes."""

    A_OP_B = 0      # X=A, Y=B: standard element-wise operation
    A_FOLD_1 = 1    # Y = {0, A[H2]}   second half of A
    A_FOLD_2 = 2    # Y = {0, A[Q2]}   second quarter
    A_FOLD_3 = 3    # Y = {0, A[HQ2]}  second half-quarter
    A_FOLD_4 = 4    # Y = {0, A[HHQ2]} second half of first half-quarter
    A_OP_NET = 5    # Y = network stream
    ZERO_OP_B = 6   # X = 0, Y = B: first iteration of MULT


def fold_source_index(block: int, level: int, pattern: str = "a") -> np.ndarray:
    """Lane index each PE's Y port reads from at fold ``level`` (1-based).

    Returns an index array ``src`` of length ``block``; lanes whose Y operand
    is the constant 0 are marked with ``-1``.
    """
    span = block >> level
    src = np.full((block,), -1, dtype=np.int64)
    if span < 1:
        raise ValueError(f"fold level {level} too deep for block of {block}")
    if pattern == "a":
        # PE i (< span) receives PE i + span.
        idx = np.arange(span)
        src[idx] = idx + span
    elif pattern == "b":
        # Adjacent folding: PE (2^level * i) receives PE (2^level*i + 2^(level-1)).
        stride = 1 << level
        idx = np.arange(0, block, stride)
        src[idx] = idx + (stride >> 1)
    else:
        raise ValueError(f"unknown fold pattern {pattern!r}")
    return src


def fold_operand(a_bits: torch.Tensor, level: int, pattern: str = "a") -> torch.Tensor:
    """Materialise the Y operand ``{0, A[...]}`` for ``A-FOLD-level``.

    ``a_bits``: ``(..., block, width)`` bit-planes.  Lanes not receiving data
    get 0 (per Table III the fold operand is zero outside the active half).
    """
    block = a_bits.shape[-2]
    src = torch.from_numpy(fold_source_index(block, level, pattern)).to(a_bits.device)
    gathered = a_bits.index_select(-2, src.clamp(min=0))
    mask = (src >= 0).to(a_bits.dtype)[:, None]
    return gathered * mask


def fold_reduce_block(a_bits: torch.Tensor, pattern: str = "a") -> torch.Tensor:
    """Sum all lanes of a PE block via successive A-FOLD serial ADDs.

    ``a_bits``: ``(block, width)``.  Returns the full ``(block, width)`` state
    after all folds; the reduction lives in lane 0 (pattern a) — exactly what
    the hardware leaves in the register file.  The operand width must already
    include enough headroom bits to hold the sum (callers sign-extend first,
    as the real machine stores products with headroom).
    """
    block, _ = a_bits.shape
    levels = int(np.log2(block))
    ops = torch.full((block,), int(OpCode.ADD), dtype=torch.int32, device=a_bits.device)
    state = a_bits
    for level in range(1, levels + 1):
        y = fold_operand(state, level, pattern)
        state, _ = serial_alu(state, y, ops)
    return state


def fold_reduce_cycles(block: int, width: int, cycles_per_bit: int = 2) -> int:
    """Cycles for the in-block fold phase: log2(block) serial ADD passes."""
    return int(np.log2(block)) * cycles_per_bit * width
