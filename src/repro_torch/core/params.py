"""Implementation-technology parameters (paper §5, Tables 1-5).

Every constant in this module is taken directly from the paper; where the
paper gives a range, both ends are kept.  Calibrated constants (values the
paper's prose under-specifies and which we fit to the paper's own anchor
numbers) are collected in :class:`CalibrationParams` and are clearly marked.

A copy of ``repro.core.params``: every constant and float is the
reference's.
"""
from __future__ import annotations

import dataclasses
import math


# ---------------------------------------------------------------------------
# Table 1 -- processing chip (28 nm logic)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ChipParams:
    process_nm: float = 28.0
    fo4_ps: float = 11.0                      # FO4 delay
    econ_area_min_mm2: float = 80.0           # economical chip size range
    econ_area_max_mm2: float = 140.0
    metal_layers: int = 8                     # M1 logic, M2/7/8 power+clock, M3-M6 wires
    wiring_layers: int = 4                    # M3-M6
    wire_pitch_um: float = 0.125              # global interconnect wire pitch
    wire_delay_ps_per_mm: float = 155.0       # optimally repeated (Table 3, 26.76 nm row)
    processor_area_mm2: float = 0.10          # XCore scaled 90 nm -> 28 nm
    switch_area_mm2: float = 0.05             # C104/SWIFT scaled
    io_pad_w_mm: float = 0.045                # 45 x 225 um, pad + driver
    io_pad_h_mm: float = 0.225
    wires_per_link_onchip: int = 18           # 9 per direction (1 ctrl + 8 data)
    wires_per_link_offchip: int = 10          # 5 per direction (1 ctrl + 4 data)
    power_ground_frac: float = 0.40           # fraction of package I/Os
    clock_ghz: float = 1.0

    @property
    def cycle_ns(self) -> float:
        return 1.0 / self.clock_ghz

    @property
    def io_pad_area_mm2(self) -> float:
        return self.io_pad_w_mm * self.io_pad_h_mm

    @property
    def shielded_wire_pitch_mm(self) -> float:
        """Half-shielded signal pitch: density drops by 1/3 (paper 4.1.2)."""
        return self.wire_pitch_um * 1.5 / 1000.0


# ---------------------------------------------------------------------------
# Table 2 -- silicon interposer (65 nm, Virtex-7 style)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class InterposerParams:
    process_nm: float = 65.0
    fo4_ps: float = 24.0
    metal_layers: int = 4                     # M1/M2 power+gnd, M3/M4 wiring
    wire_pitch_um: float = 2.0                # 333 half-shielded wires/mm
    wire_delay_ps_per_mm: float = 89.0        # repeated (Table 3, 68 nm row)
    microbump_pitch_um: float = 45.0          # 493.83 bumps/mm^2
    tsv_pitch_um: float = 210.0
    c4_pitch_um: float = 210.0
    wires_per_link: int = 10                  # 1 ctrl + 4 data per direction

    @property
    def shielded_wire_pitch_mm(self) -> float:
        # 333 half-shielded wires per mm (paper Table 2 note).
        return 1.0 / 333.0


# ---------------------------------------------------------------------------
# Table 3 -- ITRS global-wire data (used to re-derive repeated-wire delays)
# ---------------------------------------------------------------------------
# rows: (M1 half pitch nm, min global wire pitch nm, RC delay ps/mm, edition)
ITRS_GLOBAL_WIRES = (
    (150.0, 670.0, None, 2001),
    (90.0, 300.0, 96.0, 2005),
    (68.0, 210.0, 168.0, 2007),     # * used for the 65 nm interposer
    (45.0, 154.0, 385.0, 2010),
    (37.84, 114.0, 621.0, 2011),
    (26.76, 81.0, 1115.0, 2012),    # * used for the 28 nm processing chip
)


def fo4_delay_ps(feature_um: float) -> float:
    """FO4 = 360 * f heuristic (f in um, result in ps) [Ho/Horowitz]."""
    return 360.0 * feature_um


def repeated_wire_delay_ps_per_mm(fo4_ps: float, rc_ps_per_mm2: float) -> float:
    """tau = 1.47 * sqrt(FO4 * RC) (paper §5.0.1, after Bakoglu/Ho).

    ``rc_ps_per_mm2`` is the RC time constant per mm of wire, in ps/mm --
    the product of resistance and capacitance per unit length gives ps/mm^2
    scaling; with FO4 in ps the result is ps/mm.
    """
    return 1.47 * math.sqrt(fo4_ps * rc_ps_per_mm2)


# ---------------------------------------------------------------------------
# Table 4 -- memory technologies (2012 ITRS SYSD3b)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MemoryTech:
    name: str
    cell_area_factor_f2: float
    area_efficiency: float
    process_nm: float
    density_kb_per_mm2: float
    cycle_time_ns: float


SRAM = MemoryTech("sram", 140.0, 0.70, 28.0, 778.51, 0.5)
EDRAM = MemoryTech("edram", 50.0, 0.60, 28.0, 1868.42, 1.3)
COMMODITY_DRAM = MemoryTech("dram", 6.0, 0.60, 40.0, 7629.39, 30.0)

#: SRAM tile memory capacities considered in the paper (§5.0.3).
TILE_MEM_KB = (64, 128, 256, 512)


def sram_area_mm2(capacity_kb: float) -> float:
    return capacity_kb / SRAM.density_kb_per_mm2


# ---------------------------------------------------------------------------
# Table 5 -- network performance-model parameters (cycles @ 1 GHz)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class NetworkParams:
    t_switch: int = 2            # switch traversal latency
    t_open: int = 5              # additional latency to open a route
    c_cont: float = 1.0          # contention factor (zero-load sequential: 1)
    t_serial_intra: int = 0      # serialisation latency, same chip
    t_serial_inter: int = 2      # serialisation latency, crossing chips
    # t_tile and t_link come from the VLSI model (§5.1).


# ---------------------------------------------------------------------------
# Architecture structural constants (paper §2)
# ---------------------------------------------------------------------------
SWITCH_DEGREE = 32               # degree-32 crossbar switches
TILES_PER_EDGE_SWITCH = 16       # half the links of an edge switch connect tiles
TILES_PER_CHIP = 256             # economical sweet spot (§2, §5.0.1)


# ---------------------------------------------------------------------------
# Calibrated constants -- fitted to the paper's own anchors, documented here
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CalibrationParams:
    """Constants the paper's prose under-specifies.

    Each is fitted so the model reproduces the paper's published anchor
    numbers (132.9 / 44.6 mm^2 for the 256-tile 128 KB folded-Clos chip,
    87.9 mm^2 for the 2D-mesh chip, 5-8% / 2-3% interconnect fractions).
    """

    #: Pads (with driver circuitry) per off-chip link.  The paper says a chip
    #: needs "I/O for 2N links"; fitting the stated 44.6 mm^2 I/O area of the
    #: 256-tile chip gives 5 pads/link (one per unidirectional 5-wire bundle,
    #: i.e. one pad+driver per signal wire of the dominant direction; the
    #: return direction shares the driver row).
    pads_per_offchip_link: float = 5.0

    #: Switch-group packing overhead per doubling of group size ("the area
    #: grows more quickly than this due to the increasing inefficiency of
    #: larger switch groups", §5.1.2).
    switch_group_overhead_per_log2: float = 0.35

    #: Mesh switches per grid direction link bundle: degree-32 switch =
    #: 16 tile links + 4 directions x 4 links.
    mesh_links_per_direction: int = 4


CHIP = ChipParams()
INTERPOSER = InterposerParams()
NETWORK = NetworkParams()
CALIB = CalibrationParams()
