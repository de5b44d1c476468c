"""Scalability model (paper Table VI, Fig 4).

PiCaSO's design goal: the PE array scales with BRAM capacity *independent of
the slice-to-BRAM ratio*.  SPAR-2, by contrast, is placement-limited by its
unique-control-set pressure (flip-flops sharing a slice must share a control
set; too many unique sets defeat placement long before slices run out).

The model below computes, for any device, the largest array each overlay can
realise, from three bounds: BRAM capacity, slice capacity, and the
control-set placement threshold.  Control-set-per-tile constants are
calibrated to the paper's Table VI observations (SPAR-2: 32.1% at 24K PEs on
xc7vx485 failing beyond; 19.5% at 63K on U55; PiCaSO: 2.1% / 0.8%).
"""
from __future__ import annotations

from dataclasses import dataclass

from .archmodels import TABLE_IV
from .devices import Device

TILE_PES = 256  # 4x4 PE-blocks of 16 PEs
TILE_BRAM18 = 16  # one BRAM18 per 16-PE block
PLACEMENT_CTRL_THRESHOLD = 0.322  # placement fails above this (calibrated, V7)
SLICE_CEILING = 0.90  # routable fraction of device slices

# Unique control sets per tile (calibrated to Table VI; see module docstring).
CTRL_SETS_PER_TILE = {
    ("spar2", "V7"): 256.0,
    ("spar2", "US+"): 128.0,
    ("picaso", "V7"): 12.4,
    ("picaso", "US+"): 5.2,
}

# At scale the placer packs tiles tighter than the standalone-tile synthesis
# numbers of Table IV; effective slice cost = packing * table-IV slice count.
# Calibrated against Table VI's achieved slice utilisations.
SLICE_PACKING = {
    ("spar2", "V7"): 0.65,
    ("spar2", "US+"): 0.75,
    ("picaso", "V7"): 0.86,
    ("picaso", "US+"): 0.85,
}

# Same effect on LUTs (synthesis of the full array shares logic the
# standalone tile cannot); calibrated to Table VI's LUT utilisations.
LUT_PACKING = {
    ("spar2", "V7"): 0.79,
    ("spar2", "US+"): 0.89,
    ("picaso", "V7"): 0.92,
    ("picaso", "US+"): 0.99,
}


@dataclass(frozen=True)
class FitReport:
    overlay: str
    device: str
    tiles: int
    pes: int
    lut_util: float
    ff_util: float
    slice_util: float
    bram_util: float
    ctrl_util: float
    limited_by: str


def _tile_cost(overlay: str, family: str) -> tuple[int, int, int]:
    key = "benchmark" if overlay == "spar2" else "full-pipe"
    dev = "V7" if family == "V7" else "U55"
    cfg = TABLE_IV[(key, dev)]
    return cfg.lut_tile, cfg.ff_tile, cfg.slice_tile


def max_array(overlay: str, device: Device) -> FitReport:
    """Largest array of ``overlay`` ('picaso' | 'spar2') fitting ``device``."""
    lut_t, ff_t, slice_t = _tile_cost(overlay, device.family)
    key = (overlay, device.family)
    slice_eff = slice_t * SLICE_PACKING[key]
    lut_eff = lut_t * LUT_PACKING[key]
    ctrl_t = CTRL_SETS_PER_TILE[key]
    ctrl_capacity = device.slices  # ~one control set per slice

    bram_bound = device.bram18 // TILE_BRAM18
    slice_bound = int(device.slices * SLICE_CEILING / slice_eff)
    ctrl_bound = int(PLACEMENT_CTRL_THRESHOLD * ctrl_capacity / ctrl_t)
    lut_bound = int(device.luts * 0.95 / lut_eff)

    tiles = min(bram_bound, slice_bound, ctrl_bound, lut_bound)
    # Order matters on ties: the paper attributes SPAR-2's V7 failure to
    # control sets (placement), which binds before raw LUT exhaustion.
    limited_by = "bram"
    for bound, label in (
        (slice_bound, "slice"),
        (ctrl_bound, "control-sets"),
        (lut_bound, "lut"),
    ):
        if bound < {"bram": bram_bound, "slice": slice_bound,
                    "control-sets": ctrl_bound, "lut": lut_bound}[limited_by]:
            limited_by = label

    return FitReport(
        overlay=overlay,
        device=device.short_id,
        tiles=tiles,
        pes=tiles * TILE_PES,
        lut_util=tiles * lut_eff / device.luts,
        ff_util=tiles * ff_t / device.ffs,
        slice_util=tiles * slice_eff / device.slices,
        bram_util=tiles * TILE_BRAM18 / device.bram18,
        ctrl_util=tiles * ctrl_t / ctrl_capacity,
        limited_by=limited_by,
    )


def scaling_study(devices: dict[str, Device]) -> dict[str, dict[str, FitReport]]:
    """Fig 4: PiCaSO vs SPAR-2 max arrays across the Table VII device set."""
    return {
        dev_id: {ov: max_array(ov, dev) for ov in ("picaso", "spar2")}
        for dev_id, dev in devices.items()
    }
