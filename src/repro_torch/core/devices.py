"""FPGA device database (paper Table VII + the Table IV/VI evaluation parts).

LUT counts are reconstructed from Table VII's LUT-to-BRAM ratio x BRAM count
(which matches the public Xilinx numbers); FF = 2 x LUT and slices = LUT/4
(7-series, 4 LUT + 8 FF per slice) or LUT/8 (UltraScale+, 8 LUT + 16 FF).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Device:
    part: str
    family: str  # "V7" | "US+"
    bram36: int
    lut_to_bram: int
    short_id: str
    bram_fmax_mhz: float  # datasheet max BRAM clock for the speed grade

    @property
    def luts(self) -> int:
        return self.bram36 * self.lut_to_bram

    @property
    def ffs(self) -> int:
        return 2 * self.luts

    @property
    def slices(self) -> int:
        return self.luts // (4 if self.family == "V7" else 8)

    @property
    def bram18(self) -> int:
        return 2 * self.bram36

    @property
    def max_pes(self) -> int:
        """PiCaSO fits 16 bit-serial PEs per BRAM18 (paper §III-A)."""
        return 16 * self.bram18


# Paper Table VII (speed-grade fmax: -2 V7 ~ 543.77 MHz, -3/-2 US+ ~ 737 MHz).
TABLE_VII = {
    "V7-a": Device("xc7vx330tffg-2", "V7", 750, 272, "V7-a", 543.77),
    "V7-b": Device("xc7vx485tffg-2", "V7", 1030, 295, "V7-b", 543.77),
    "V7-c": Device("xc7v2000tfhg-2", "V7", 1292, 946, "V7-c", 543.77),
    "V7-d": Device("xc7vx1140tflg-2", "V7", 1880, 379, "V7-d", 543.77),
    "US-a": Device("xcvu3p-ffvc-3", "US+", 720, 547, "US-a", 737.0),
    "US-b": Device("xcvu23p-vsva-3", "US+", 2112, 488, "US-b", 737.0),
    "US-c": Device("xcvu19p-fsvb-2", "US+", 2160, 1892, "US-c", 737.0),
    "US-d": Device("xcvu29p-figd-3", "US+", 2688, 643, "US-d", 737.0),
}

# Evaluation devices of Tables IV and VI.
VIRTEX7_485 = TABLE_VII["V7-b"]  # xc7vx485 is the paper's Virtex-7 eval part
ALVEO_U55 = Device("xcu55c-fsvh2892-2L", "US+", 2016, 647, "U55", 737.0)

ALL_DEVICES = dict(TABLE_VII, U55=ALVEO_U55)
