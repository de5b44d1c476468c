"""Functional PiCaSO array simulator with cycle accounting.

Twin of ``repro.core.simulator``.  The machine is a grid of PE-blocks (16
bit-serial PEs each, one BRAM18 per block).  State is the striped register
file: ``(n_blocks, 16, rf_depth)`` single-bit planes, a uint8 tensor on the
array's device.  Instructions operate on *address ranges* of the register
file, exactly like the hardware's wordline addressing, and every instruction
charges its paper-formula cycle cost to a counter — so the simulator both
computes correct values (validated against integer oracles) and reproduces
the Table V latencies.  The cycle counts are the paper's model, not a
measurement of the device the array runs on.

The array owns ``rf`` and writes it in place; its address ranges are read as
views, and every function that takes one returns a new tensor.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.models.common import resolve_device

from . import costmodel as cm
from .alu import serial_alu
from .bitops import from_bits, sign_extend_bits, to_bits
from .booth import booth_multiply_bits
from .isa import OpCode
from .network import network_reduce_bits
from .opmux import fold_operand

BLOCK = 16


@dataclass
class PicasoArray:
    """A PiCaSO PIM array of ``n_blocks`` 16-PE blocks with ``rf_depth``-bit
    register files (1024 in the widest Virtex BRAM mode), on ``device``
    (None: the card; raises where there is none)."""

    n_blocks: int
    rf_depth: int = 1024
    pipeline: str = "full-pipe"  # affects only the cycle model
    device: torch.device | str | None = None
    rf: torch.Tensor = field(init=False)
    cycles: int = field(default=0, init=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.rf = torch.zeros((self.n_blocks, BLOCK, self.rf_depth), dtype=torch.uint8,
                              device=self.device)

    # ------------------------------------------------------------- helpers --
    @property
    def num_pes(self) -> int:
        return self.n_blocks * BLOCK

    def _slice(self, addr: int, width: int) -> torch.Tensor:
        return self.rf[:, :, addr : addr + width]

    def _store(self, addr: int, bits: torch.Tensor) -> None:
        width = bits.shape[-1]
        self.rf[:, :, addr : addr + width] = bits

    def _ops(self, op: OpCode) -> torch.Tensor:
        return torch.full((self.num_pes,), int(op), dtype=torch.int32, device=self.device)

    # -------------------------------------------------------------- I/O -----
    def write_operands(self, addr: int, values, width: int) -> None:
        """Corner-turn parallel words into striped bit-serial storage.

        ``values``: ``(n_blocks, 16)`` integers (two's complement width-bit).
        The corner-turn happens at the memory interface and is not charged to
        the PE array (paper §III-A: done by the I/O path).
        """
        self._store(addr, to_bits(torch.as_tensor(values, device=self.device), width))

    def read_operands(self, addr: int, width: int, signed: bool = True) -> torch.Tensor:
        return from_bits(self._slice(addr, width), signed=signed)

    # ------------------------------------------------------- instructions ---
    def alu_op(self, op: OpCode, xa: int, ya: int, dest: int, width: int) -> None:
        """Element-wise serial ALU op: RF[dest] = RF[xa] op RF[ya]."""
        x = self._slice(xa, width).reshape(self.num_pes, width)
        y = self._slice(ya, width).reshape(self.num_pes, width)
        s, _ = serial_alu(x, y, self._ops(op))
        self._store(dest, s.reshape(self.n_blocks, BLOCK, width))
        self.cycles += cm.add_sub_cycles(width)

    def mult(self, xa: int, ya: int, dest: int, width: int) -> None:
        """Booth radix-2 multiply: RF[dest:dest+2N] = RF[xa] * RF[ya]."""
        m = self._slice(xa, width).reshape(self.num_pes, width)
        y = self._slice(ya, width).reshape(self.num_pes, width)
        p = booth_multiply_bits(m, y)
        self._store(dest, p.reshape(self.n_blocks, BLOCK, 2 * width))
        self.cycles += cm.mult_cycles_overlay(width)

    def fold_accumulate(self, addr: int, width: int, pattern: str = "a") -> None:
        """In-block OpMux fold reduction: lane 0 of each block gets the block sum.

        ``width`` must include headroom (callers place 2N-bit products plus
        log2(16)=4 guard bits before reducing, as the hardware does).
        """
        state = self._slice(addr, width)
        ops = self._ops(OpCode.ADD)
        for level in range(1, 5):  # A-FOLD-1..4 over 16 lanes
            y = fold_operand(state, level, pattern)
            s, _ = serial_alu(
                state.reshape(self.num_pes, width),
                y.reshape(self.num_pes, width),
                ops,
            )
            state = s.reshape(self.n_blocks, BLOCK, width)
        self._store(addr, state)
        # Full-Pipe folds run at 1 cycle/bit (Table V: the 4N term).
        self.cycles += 4 * width

    def network_accumulate(self, addr: int, width: int) -> None:
        """Binary-hopping reduction of each block's lane-0 into block 0."""
        lane0 = self._slice(addr, width)[:, 0, :]  # (n_blocks, width), a view
        self.rf[:, 0, addr : addr + width] = network_reduce_bits(lane0)
        jumps = cm.log2i(self.n_blocks) if self.n_blocks > 1 else 0
        self.cycles += jumps * (width + 4)  # (N+4) per network jump (Table V)

    # --------------------------------------------------------- composites ---
    def accumulate_row(self, addr: int, width: int) -> None:
        """Full q-column accumulation: folds then network (paper Table V).

        Charges the full PiCaSO-F accumulation formula including the fixed
        pipeline overhead, replacing the two phases' individual charges.
        """
        c0 = self.cycles
        self.fold_accumulate(addr, width)
        if self.n_blocks > 1:
            self.network_accumulate(addr, width)
        self.cycles = c0 + cm.accum_cycles_picaso(self.num_pes, width)

    def result_scalar(self, addr: int, width: int) -> torch.Tensor:
        """The accumulation result: block 0, lane 0."""
        return from_bits(self.rf[0, 0, addr : addr + width], signed=True)


def simulate_dot_product(
    x: np.ndarray, w: np.ndarray, width: int, rf_depth: int = 1024, device=None
) -> tuple[int, int]:
    """Map a q-length dot product onto a PiCaSO row and run it.

    Returns ``(value, cycles)``.  q must be a multiple of 16 (block size);
    operands are signed ``width``-bit.  Raises ``ValueError`` where the
    accumulator (``2*width + log2(q) + 1`` bits) is wider than 32, as the
    JAX package does.
    """
    q = len(x)
    n_blocks = max(q // BLOCK, 1)
    arr = PicasoArray(n_blocks=n_blocks, rf_depth=rf_depth, device=device)
    xs = torch.as_tensor(np.asarray(x)).reshape(n_blocks, BLOCK)
    ws = torch.as_tensor(np.asarray(w)).reshape(n_blocks, BLOCK)

    a_x, a_w, a_p = 0, width, 2 * width
    acc_width = 2 * width + cm.log2i(max(q, 2)) + 1  # headroom for the sum
    arr.write_operands(a_x, xs, width)
    arr.write_operands(a_w, ws, width)
    arr.mult(a_x, a_w, a_p, width)
    # Sign-extend products to accumulator width in place (free in HW: the
    # fold ALU pass reads the MSB repeatedly; we charge no extra cycles).
    arr._store(a_p, sign_extend_bits(arr._slice(a_p, 2 * width), acc_width))
    arr.accumulate_row(a_p, acc_width)
    return int(arr.result_scalar(a_p, acc_width)), arr.cycles
