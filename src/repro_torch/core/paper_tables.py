"""One function per paper table/figure, on the port's PiCaSO model.

Twin of the JAX package's ``benchmarks/paper_tables.py``: the same seven
functions, ``ALL``, and the same rows.  Each function returns CSV rows
``(name, us_per_call, derived)``: ``derived`` is the reproduced quantity
compared against the paper's published value, and ``us_per_call`` the wall
time of the artifact that produces it (the simulator, or a model
evaluation), timed here with the device synchronised around each call.  The
cycle counts, MHz and TMAC/s are the paper's analytical model of the FPGA
overlay, not measurements of the device the functions run on.

    python -m repro_torch.core.paper_tables [--device cpu]

prints ``name,us_per_call,derived`` CSV; with no ``--device`` it runs on the
card and fails where there is none.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.models.common import resolve_device

from . import costmodel as cm
from .archmodels import (
    ARCHS,
    TABLE_IV,
    memory_efficiency_table,
    peak_throughput_table,
    relative_mac_latency,
)
from .devices import ALVEO_U55, TABLE_VII, VIRTEX7_485
from .scalability import max_array, scaling_study
from .simulator import simulate_dot_product


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timeit(fn, device: torch.device, n=3):
    """Microseconds a call of ``fn``, after one warm call; the device is
    synchronised before and after each timed call."""
    fn()  # warm
    total = 0.0
    for _ in range(n):
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        total += time.perf_counter() - t0
    return total / n * 1e6


def table4_overlay_configs(device=None):
    resolve_device(device)
    rows = []
    for (name, dev), cfg in TABLE_IV.items():
        rows.append((f"table4/{name}/{dev}/fmax_mhz", 0.0, cfg.fmax_mhz))
        rows.append((f"table4/{name}/{dev}/slice_tile", 0.0, cfg.slice_tile))
    v7 = TABLE_IV[("full-pipe", "V7")].fmax_mhz / TABLE_IV[("benchmark", "V7")].fmax_mhz
    u55 = TABLE_IV[("full-pipe", "U55")].fmax_mhz / TABLE_IV[("benchmark", "U55")].fmax_mhz
    rows.append(("table4/speedup_vs_spar2/V7 (paper 2.25x)", 0.0, round(v7, 3)))
    rows.append(("table4/speedup_vs_spar2/U55 (paper 1.67x)", 0.0, round(u55, 3)))
    return rows


def table5_cycle_latency(device=None):
    device = resolve_device(device)
    rows = []
    q, n = 128, 32
    rows.append(("table5/addsub_2N", 0.0, cm.add_sub_cycles(n)))
    rows.append(("table5/mult_2N2+2N", 0.0, cm.mult_cycles_overlay(n)))
    rows.append(("table5/accum_spar2 (paper 4512)", 0.0, cm.accum_cycles_spar2(q, n)))
    rows.append(("table5/accum_picaso (paper 259)", 0.0, cm.accum_cycles_picaso(q, n)))
    rows.append(
        ("table5/accum_improvement (paper 17x)", 0.0,
         round(cm.accum_cycles_spar2(q, n) / cm.accum_cycles_picaso(q, n), 2))
    )
    # functional cross-check: simulate a real dot product, time it
    rng = np.random.default_rng(0)
    x = rng.integers(-128, 128, size=64)
    w = rng.integers(-128, 128, size=64)
    us = _timeit(lambda: simulate_dot_product(x, w, 8, device=device), device, n=1)
    val, cycles = simulate_dot_product(x, w, 8, device=device)
    ref = int(np.dot(x.astype(np.int64), w.astype(np.int64)))
    rows.append(("table5/sim_dot64_correct", us, int(val == ref)))
    rows.append(("table5/sim_dot64_cycles", us, cycles))
    return rows


def table6_fig4_scalability(device=None):
    device = resolve_device(device)
    rows = []
    for overlay, dev, paper_pes in (
        ("spar2", VIRTEX7_485, 24_000), ("picaso", VIRTEX7_485, 33_000),
        ("spar2", ALVEO_U55, 63_000), ("picaso", ALVEO_U55, 64_000),
    ):
        us = _timeit(lambda: max_array(overlay, dev), device)
        rep = max_array(overlay, dev)
        rows.append(
            (f"table6/{overlay}/{dev.short_id}/max_pes (paper {paper_pes})", us, rep.pes)
        )
        rows.append(
            (f"table6/{overlay}/{dev.short_id}/limited_by", 0.0, rep.limited_by)
        )
    study = scaling_study(TABLE_VII)
    for dev_id, reports in study.items():
        rows.append(
            (f"fig4/picaso/{dev_id}/bram_util", 0.0,
             round(reports["picaso"].bram_util, 3))
        )
    return rows


def fig5_mac_latency(device=None):
    resolve_device(device)
    rows = []
    for n in (4, 8, 16):
        rel = relative_mac_latency(n)
        for name, r in rel.items():
            rows.append((f"fig5/rel_latency/N{n}/{name}", 0.0, round(r, 3)))
    r4 = relative_mac_latency(4)["CoMeFa-A"]
    rows.append(("fig5/comefa_a_max (paper 2.56x)", 0.0, round(r4, 2)))
    return rows


def fig6_throughput(device=None):
    resolve_device(device)
    rows = []
    for n in (4, 8, 16):
        thr = peak_throughput_table(n)
        for name, t in thr.items():
            rows.append((f"fig6/tmacs/N{n}/{name}", 0.0, round(t, 4)))
        frac = thr["PiCaSO-F"] / thr["CoMeFa-A"]
        rows.append((f"fig6/picaso_vs_comefa_a/N{n} (paper 0.75-0.80)", 0.0,
                     round(frac, 3)))
        # without Booth NOP-skip credit
        no_booth = ARCHS["PiCaSO-F"].peak_tmacs(n, ALVEO_U55, booth_avg=False)
        rows.append((f"fig6/picaso_no_booth/N{n}", 0.0, round(no_booth, 4)))
    return rows


def fig7_memory_efficiency(device=None):
    resolve_device(device)
    rows = []
    for n in (4, 8, 16, 32):
        eff = memory_efficiency_table(n)
        for name, e in eff.items():
            rows.append((f"fig7/mem_eff/N{n}/{name}", 0.0, round(e, 4)))
    e16 = memory_efficiency_table(16)
    rows.append(("fig7/ccb_16b (paper 0.50)", 0.0, round(e16["CCB"], 3)))
    rows.append(("fig7/comefa_16b (paper 0.688)", 0.0, round(e16["CoMeFa-A"], 3)))
    rows.append(("fig7/picaso_16b (paper 0.938)", 0.0, round(e16["PiCaSO-F"], 3)))
    rows.append(
        ("fig7/amod_gain_16b (paper +0.062)", 0.0,
         round(e16["A-Mod"] - e16["CoMeFa-A"], 4))
    )
    return rows


def table8_summary(device=None):
    resolve_device(device)
    rows = []
    for name, arch in ARCHS.items():
        rows.append((f"table8/{name}/clock_overhead", 0.0, arch.clock_overhead))
        rows.append((f"table8/{name}/parallel_macs", 0.0, arch.parallel_macs_per_bram36))
        rows.append((f"table8/{name}/mult_cycles_N8", 0.0, arch.mult_cycles(8)))
        rows.append((f"table8/{name}/accum_cycles_q16_N8", 0.0, arch.accum_cycles(16, 8)))
        rows.append((f"table8/{name}/booth", 0.0, arch.booth))
    # A-Mod improvements over CoMeFa-A (paper: lat -19.5%, thr +18%, mem +6.2pp)
    base = ARCHS["CoMeFa-A"].mac16_latency_us(16, ALVEO_U55)
    mod = ARCHS["A-Mod"].mac16_latency_us(16, ALVEO_U55)
    rows.append(("table8/amod_latency_gain_N16 (paper ~0.195)", 0.0,
                 round(1 - mod / base, 3)))
    return rows


ALL = [
    table4_overlay_configs,
    table5_cycle_latency,
    table6_fig4_scalability,
    fig5_mac_latency,
    fig6_throughput,
    fig7_memory_efficiency,
    table8_summary,
]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the card)")
    device = resolve_device(ap.parse_args(argv).device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "the CPU"
    print(f"us_per_call timed on {name}; the cycles, MHz and TMAC/s are the paper's "
          "model of the FPGA overlay, not measurements", file=sys.stderr)
    print("name,us_per_call,derived")
    for suite in ALL:
        for name, us, derived in suite(device):
            print(f"{name},{us:.2f},{derived}")


if __name__ == "__main__":
    main()
