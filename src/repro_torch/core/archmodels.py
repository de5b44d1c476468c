"""Analytical models of the compared PIM architectures (paper Tables IV & VIII,
Figs 5-7): CCB, CoMeFa-D/A, PiCaSO-F, A-Mod/D-Mod, plus the SPAR-2 benchmark
overlay.

Every number used by the benchmarks is produced by these models; the paper's
published values are kept in tests/ as goldens.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from . import costmodel as cm
from .devices import ALVEO_U55, VIRTEX7_485, Device


# ------------------------------------------------------------- Table IV -----
@dataclass(frozen=True)
class PipelineConfig:
    """One overlay pipeline configuration, per device (paper Table IV).

    Utilisation is per tile = 4x4 PE-blocks = 256 PEs (tile) and per block
    (16 PEs).
    """

    name: str
    device: str  # "V7" | "U55"
    lut_tile: int
    ff_tile: int
    slice_tile: int
    fmax_mhz: float

    @property
    def lut_block(self) -> int:
        return self.lut_tile // 16

    @property
    def ff_block(self) -> int:
        return self.ff_tile // 16

    @property
    def slice_block(self) -> int:
        return self.slice_tile // 16


TABLE_IV = {
    ("benchmark", "V7"): PipelineConfig("benchmark", "V7", 3023, 1024, 1056, 240.0),
    ("benchmark", "U55"): PipelineConfig("benchmark", "U55", 2449, 768, 556, 445.0),
    ("full-pipe", "V7"): PipelineConfig("full-pipe", "V7", 835, 1799, 522, 540.0),
    ("full-pipe", "U55"): PipelineConfig("full-pipe", "U55", 774, 1799, 243, 737.0),
    ("single-cycle", "V7"): PipelineConfig("single-cycle", "V7", 895, 1031, 395, 245.0),
    ("single-cycle", "U55"): PipelineConfig("single-cycle", "U55", 1068, 1031, 223, 487.0),
    ("rf-pipe", "V7"): PipelineConfig("rf-pipe", "V7", 1017, 1543, 451, 360.0),
    ("rf-pipe", "U55"): PipelineConfig("rf-pipe", "U55", 1064, 1527, 243, 600.0),
    ("op-pipe", "V7"): PipelineConfig("op-pipe", "V7", 836, 1543, 472, 370.0),
    ("op-pipe", "U55"): PipelineConfig("op-pipe", "U55", 774, 1543, 295, 620.0),
}


# ------------------------------------------------------------ Table VIII ----
@dataclass(frozen=True)
class PimArch:
    """One PIM architecture's analytical model (paper Table VIII columns)."""

    name: str
    kind: str  # "custom" | "overlay"
    clock_overhead: float  # fractional fmax degradation vs the BRAM fmax
    parallel_macs_per_bram36: int
    mult_cycles: Callable[[int], int]
    accum_cycles: Callable[[int, int], int]  # (q, n) -> cycles
    reserved_wordlines_per_bit: int  # scratchpad wordlines per operand bit
    rf_bits_per_pe: int  # register-file (bitline) depth per PE
    booth: str  # "yes" | "partial" | "no"
    complexity: str
    practicality: str

    def fmax(self, device: Device) -> float:
        """Achievable clock (MHz): BRAM fmax degraded by the design's overhead."""
        return device.bram_fmax_mhz / (1.0 + self.clock_overhead)

    # ---- Fig 7: BRAM memory-utilisation efficiency ----
    def memory_efficiency(self, n: int) -> float:
        """Fraction of BRAM usable for model weights at N-bit precision.

        CCB needs 8N reserved wordlines (Neural-Cache style scratch), CoMeFa
        5N (OOOR), PiCaSO and the -Mod designs 4N (zero-copy OpMux folds).
        """
        reserved = self.reserved_wordlines_per_bit * n
        return (self.rf_bits_per_pe - reserved) / self.rf_bits_per_pe

    # ---- Fig 5: latency of 16 parallel MULTs + product accumulation ----
    def mac16_latency_us(self, n: int, device: Device, booth_avg: bool = False) -> float:
        mult = self.mult_cycles(n)
        if booth_avg and self.booth == "yes":
            mult //= 2
        cycles = mult + self.accum_cycles(16, n)
        return cycles / self.fmax(device)  # MHz -> us

    # ---- Fig 6: peak MAC throughput on a device ----
    def peak_tmacs(self, n: int, device: Device, booth_avg: bool = True) -> float:
        """Peak TeraMAC/s: all PEs issuing back-to-back MULTs.

        The paper's Fig 6 peak assumes the controller exploits Booth NOP
        skipping on the overlay (§V-B) — we expose the flag so both numbers
        are reported.
        """
        mult = self.mult_cycles(n)
        if booth_avg and self.booth == "yes":
            mult //= 2
        pes = self.parallel_macs_per_bram36 * device.bram36
        return pes * self.fmax(device) * 1e6 / mult / 1e12


ARCHS = {
    "CCB": PimArch(
        "CCB", "custom", 0.60, 144, cm.mult_cycles_custom, cm.accum_cycles_custom,
        8, 256, "no", "high", "low",
    ),
    "CoMeFa-D": PimArch(
        "CoMeFa-D", "custom", 0.25, 144, cm.mult_cycles_custom, cm.accum_cycles_custom,
        5, 256, "partial", "medium", "medium",
    ),
    "CoMeFa-A": PimArch(
        "CoMeFa-A", "custom", 1.50, 144, cm.mult_cycles_custom, cm.accum_cycles_custom,
        5, 256, "partial", "medium", "high",
    ),
    "PiCaSO-F": PimArch(
        "PiCaSO-F", "overlay", 0.0, 36, cm.mult_cycles_overlay,
        cm.accum_cycles_picaso_block, 4, 1024, "yes", "none", "very high",
    ),
    "A-Mod": PimArch(
        "A-Mod", "custom", 1.50, 144, cm.mult_cycles_custom, cm.accum_cycles_amod,
        4, 256, "yes", "medium", "high",
    ),
    "D-Mod": PimArch(
        "D-Mod", "custom", 0.25, 144, cm.mult_cycles_custom, cm.accum_cycles_amod,
        4, 256, "yes", "medium", "medium",
    ),
}

# SPAR-2 (benchmark overlay) for the Table V comparison: NEWS-network copies.
SPAR2 = PimArch(
    "SPAR-2", "overlay", 0.0, 32, cm.mult_cycles_overlay, cm.accum_cycles_spar2,
    4, 1024, "yes", "none", "high",
)


def relative_mac_latency(n: int, device: Device = ALVEO_U55) -> dict[str, float]:
    """Fig 5: MAC latency of each design relative to PiCaSO-F (>1 = slower)."""
    base = ARCHS["PiCaSO-F"].mac16_latency_us(n, device)
    return {
        name: arch.mac16_latency_us(n, device) / base
        for name, arch in ARCHS.items()
    }


def peak_throughput_table(n: int, device: Device = ALVEO_U55) -> dict[str, float]:
    """Fig 6: peak TeraMAC/s per design on the given device."""
    return {name: arch.peak_tmacs(n, device) for name, arch in ARCHS.items()}


def memory_efficiency_table(n: int) -> dict[str, float]:
    """Fig 7 points at precision n."""
    return {name: arch.memory_efficiency(n) for name, arch in ARCHS.items()}


__all__ = [
    "ARCHS", "SPAR2", "TABLE_IV", "PimArch", "PipelineConfig",
    "relative_mac_latency", "peak_throughput_table", "memory_efficiency_table",
    "ALVEO_U55", "VIRTEX7_485",
]
