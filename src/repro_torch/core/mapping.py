"""Map linear-algebra workloads onto the PiCaSO array (corner turning +
row-per-output scheduling) — the application layer of the paper's machine.

Twin of ``repro.core.mapping``.  A matvec ``W (M, K) @ x (K,)`` maps one
output element per PE *row* of K PEs: weights are corner-turned into
bit-serial columns (§III-A), every row multiplies element-wise with the
broadcast activation (Booth, all rows in parallel — SIMD), then each row
fold/network-reduces into its PE 0.  The cycle model is therefore one MULT +
one row-accumulation regardless of M, as long as M rows fit the array —
exactly the scaling argument of the paper's throughput analysis (Fig 6).
"""
from __future__ import annotations

import numpy as np

from . import costmodel as cm
from .simulator import BLOCK, simulate_dot_product


def matvec_cycles(m_rows: int, k: int, width: int, total_pes: int,
                  booth_avg: bool = False) -> int:
    """Cycles for W(M,K) @ x on an array of ``total_pes`` bit-serial PEs."""
    rows_at_once = max(total_pes // k, 1)
    waves = -(-m_rows // rows_at_once)
    mult = (cm.mult_cycles_overlay_booth_avg(width) if booth_avg
            else cm.mult_cycles_overlay(width))
    acc_w = 2 * width + cm.log2i(max(k, 2)) + 1
    return waves * (mult + cm.accum_cycles_picaso(k, acc_w))


def simulate_matvec(w: np.ndarray, x: np.ndarray, width: int, device=None):
    """Functionally execute W @ x on the simulated array (row per wave), on
    ``device`` (None: the card; raises where there is none).

    Returns (values (M,), cycles) with the parallel-wave cycle model (rows
    run SIMD-parallel in hardware; the functional sim iterates them).
    """
    m, k = w.shape
    assert k % BLOCK == 0, f"K={k} must be a multiple of the 16-PE block"
    vals = np.empty((m,), dtype=np.int64)
    per_row_cycles = 0
    for i in range(m):
        vals[i], per_row_cycles = simulate_dot_product(x, w[i], width, device=device)
    # SIMD: all rows that fit the array execute in the same wave.
    total = matvec_cycles(m, k, width, total_pes=max(m * k, k))
    assert total == per_row_cycles, (total, per_row_cycles)
    return vals, total
