"""Binary-hopping reduction network between PIM blocks (paper Fig 3, §III-D).

Twin of ``repro.core.network``.  Each network node (one per PE-block) is
configured per *level* L as a Transmitter (T), Receiver (R) or
Pass-through (P):

  level 0: even nodes receive from their right neighbour,
  level 1: every 4th node receives from node+2 (the node between is a P),
  level L: nodes with index % 2^(L+1) == 0 receive from index + 2^L.

During accumulation the transmitter's operand bits *stream* through P nodes
into the receiver's serial ALU (OpMux conf ``A-OP-NET``), so transfer overlaps
with computation; only the pipeline fill of the hop chain is exposed, which is
why a network jump costs ``N + 4`` cycles (Table V) instead of a full
store-and-forward copy.

Like the JAX package, ``network_reduce_bits`` runs ``int(log2(n_blocks))``
levels, so for a block count that is not a power of two the blocks past the
last power of two are not added (kept as the reference has it).
"""
from __future__ import annotations

import numpy as np
import torch

from .alu import serial_alu
from .isa import OpCode


def node_roles(n_nodes: int, level: int) -> list[str]:
    """Role of each node at ``level``: 'R', 'T', 'P' or '-' (idle)."""
    roles = []
    stride = 1 << (level + 1)
    span = 1 << level
    for i in range(n_nodes):
        if i % stride == 0 and i + span < n_nodes:
            roles.append("R")
        elif i % stride == span:
            roles.append("T")
        elif i % stride and i % stride < span:
            roles.append("P")  # sits between a later T and its R
        else:
            roles.append("P" if i % stride else "-")
    return roles


def network_reduce_bits(block_bits: torch.Tensor) -> torch.Tensor:
    """Reduce lane-0 operands across blocks via binary hopping.

    ``block_bits``: ``(n_blocks, width)`` bit-planes (each block's partial
    sum, i.e. its PE-0 register after the in-block folds).  Returns the state
    after all levels in a new tensor, ``block_bits`` left as it was; the
    total lands in block 0.  Width must already include headroom for the sum.
    """
    n_blocks, _ = block_bits.shape
    levels = int(np.log2(n_blocks))
    state = block_bits.clone()
    for level in range(levels):
        span = 1 << level
        recv = np.arange(0, n_blocks, 1 << (level + 1))
        recv = torch.from_numpy(recv[recv + span < n_blocks]).to(block_bits.device)
        x = state[recv]  # receivers' operands
        y = state[recv + span]  # transmitters', streamed over the net
        ops = torch.full((len(recv),), int(OpCode.ADD), dtype=torch.int32,
                         device=block_bits.device)
        s, _ = serial_alu(x, y, ops)
        state[recv] = s
    return state


def network_jump_cycles(width: int, fill: int = 4) -> int:
    """Cycles per network level: serial add of N bits + hop-chain fill."""
    return width + fill


def network_levels(n_blocks: int) -> int:
    return int(np.log2(n_blocks)) if n_blocks > 1 else 0
