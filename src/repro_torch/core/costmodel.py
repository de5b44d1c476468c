"""Closed-form cycle-latency models (paper Tables V and VIII).

These are the paper's own analytical formulas, used both to reproduce its
tables and as the cost-accounting layer of the functional simulator.

Notation: N = operand width (bits), q = number of columns (PEs) accumulated.
"""
from __future__ import annotations

import math

BLOCK = 16  # PEs per PE-block (one BRAM's port width of bit-serial lanes)


def log2i(x: float) -> int:
    return int(round(math.log2(x)))


# ---------------------------------------------------------------- Table V ---
def add_sub_cycles(n: int) -> int:
    """ADD/SUB: 2N (both PiCaSO and the SPAR-2 benchmark)."""
    return 2 * n


def mult_cycles_overlay(n: int) -> int:
    """Booth radix-2 MULT on the overlay: 2N^2 + 2N (Table V / Table VIII(b))."""
    return 2 * n * n + 2 * n


def mult_cycles_overlay_booth_avg(n: int) -> int:
    """Average-case overlay MULT when the controller skips Booth NOPs.

    §V-B: half of Booth's intermediate steps are NOPs on average, so the
    multiplication latency can be reduced by ~50%.
    """
    return mult_cycles_overlay(n) // 2


def mult_cycles_custom(n: int) -> int:
    """Custom PIM blocks (CCB/CoMeFa): N^2 + 3N - 2 (Table VIII(a)).

    Custom designs extend the clock to a full read-modify-write per cycle, so
    a MULT takes roughly half the cycles of the 2-cycle-per-bit overlay.
    """
    return n * n + 3 * n - 2


def accum_cycles_spar2(q: int, n: int) -> int:
    """SPAR-2 NEWS-network accumulation: (q - 1 + 2*log2 q) * N (Table V)."""
    return (q - 1 + 2 * log2i(q)) * n


def accum_cycles_picaso(q: int, n: int) -> int:
    """PiCaSO-F accumulation: 15 + q/16 + 4N + (N+4)*J, J = log2(q/16).

    15 = controller/pipeline fixed overhead, q/16 = per-block drain, 4N = the
    four in-block OpMux folds (1 cycle/bit in Full-Pipe), (N+4) per network
    jump (serial add overlapped with hopping; 4 = hop-chain fill).
    For q <= 16 only the fold phase applies and the formula reduces to the
    Table VIII(d) form (N+4)*log2(q) when q = 16.
    """
    j = max(log2i(q) - log2i(BLOCK), 0)
    return 15 + q // BLOCK + 4 * n + (n + 4) * j


def accum_cycles_custom(q: int, n: int) -> int:
    """CCB / CoMeFa accumulation: (2N + log2 q) * log2 q (Table VIII(c)).

    Requires copying operands between bitlines each halving step (2N cycles
    of copy + log-step alignment) — no zero-copy fold.
    """
    return (2 * n + log2i(q)) * log2i(q)


def accum_cycles_picaso_block(q: int, n: int) -> int:
    """PiCaSO per-block form (N+4)*log2 q — Table VIII(d)."""
    return (n + 4) * log2i(q)


def accum_cycles_amod(q: int, n: int) -> int:
    """A-Mod / D-Mod (custom + PiCaSO OpMux/network): (N+2)*log2 q (VIII(e)).

    The custom RMW port saves the overlay's extra read cycle, and the OpMux
    removes the operand copies, leaving N+2 per halving step.
    """
    return (n + 2) * log2i(q)


# -------------------------------------------------------- composite ops -----
def mac16_cycles_overlay(n: int, booth_avg: bool = False) -> int:
    """16 parallel MULTs + in-block accumulation of the 16 products (Fig 5)."""
    mult = mult_cycles_overlay_booth_avg(n) if booth_avg else mult_cycles_overlay(n)
    return mult + accum_cycles_picaso_block(BLOCK, n)


def mac16_cycles_custom(n: int) -> int:
    return mult_cycles_custom(n) + accum_cycles_custom(BLOCK, n)


def mac16_cycles_mod(n: int) -> int:
    """A-Mod / D-Mod: custom MULT + PiCaSO-style zero-copy accumulation."""
    return mult_cycles_custom(n) + accum_cycles_amod(BLOCK, n)


def matvec_cycles_overlay(q: int, n: int, booth_avg: bool = False) -> int:
    """q-wide dot product on a PiCaSO row: q parallel MULTs + full reduction."""
    mult = mult_cycles_overlay_booth_avg(n) if booth_avg else mult_cycles_overlay(n)
    return mult + accum_cycles_picaso(q, n)
