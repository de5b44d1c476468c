"""PiCaSO PIM array walk-through: the paper's machine, end to end.

Twin of the JAX package's ``examples/pim_array_demo.py``, with the same
printed values.  Runs a 128-wide dot product on the simulated bit-serial
overlay exactly the way the hardware does it — corner-turn, Booth multiply,
OpMux folds, binary-hopping network reduction — validates the value against
numpy, and prints the cycle count next to the paper's Table V formulas and
the SPAR-2 baseline.  Cycle counts, TMAC/s and clocks are the paper's
analytical model of the FPGA overlay, not measurements of the device the
simulator runs on.

    python -m repro_torch.core.array_demo [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.models.common import resolve_device

from . import archmodels, costmodel as cm
from .simulator import simulate_dot_product


def main(device=None):
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    q, width = 128, 8
    x = rng.integers(-128, 128, size=q)
    w = rng.integers(-128, 128, size=q)

    print(f"== {q}-element dot product, {width}-bit operands ==")
    val, cycles = simulate_dot_product(x, w, width, device=device)
    ref = int(np.dot(x.astype(np.int64), w.astype(np.int64)))
    print(f"simulated PiCaSO value : {val}")
    print(f"numpy reference        : {ref}")
    if val != ref:
        raise SystemExit(f"simulated value {val} differs from numpy's {ref}")
    print(f"cycle count            : {cycles}")

    acc_w = 2 * width + cm.log2i(q) + 1
    spar2 = cm.mult_cycles_overlay(width) + cm.accum_cycles_spar2(q, acc_w)
    print(f"SPAR-2 (NEWS) cycles   : {spar2}  "
          f"({spar2 / cycles:.1f}x slower accumulation)")

    print("\n== Table V headline (q=128, N=32) ==")
    print(f"SPAR-2 accumulation  : {cm.accum_cycles_spar2(128, 32)} cycles")
    print(f"PiCaSO-F accumulation: {cm.accum_cycles_picaso(128, 32)} cycles "
          f"(17x faster)")

    print("\n== paper Fig 5/6/7 at 8-bit on Alveo U55 ==")
    rel = archmodels.relative_mac_latency(8)
    thr = archmodels.peak_throughput_table(8)
    eff = archmodels.memory_efficiency_table(8)
    for name in ("CCB", "CoMeFa-D", "CoMeFa-A", "PiCaSO-F", "A-Mod"):
        print(f"  {name:9s} rel-latency {rel[name]:5.2f}x   "
              f"peak {thr[name]:6.3f} TMAC/s   mem-eff {eff[name]*100:5.1f}%")
    print(f"\nPiCaSO/CoMeFa-A throughput: "
          f"{thr['PiCaSO-F']/thr['CoMeFa-A']*100:.0f}% (paper: 75-80%)")
    print(f"\n(simulated on {device}; every cycle count and TMAC/s above is the "
          "paper's model of the FPGA overlay, not a measurement)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device to simulate on (default: the card)")
    main(ap.parse_args().device)
