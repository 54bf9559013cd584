"""VLSI floorplan / area / wire-delay model (paper §4-5, Figures 5-7).

The model reproduces, from first principles plus the Table 1/2/4 parameters:

* folded-Clos chip: recursive H-tree of leaf groups (16 tiles + edge switch),
  staggered switch groups at H-tree nodes, cross-shaped wiring channels whose
  widths are set by the wires that must cross them, and an I/O pad column for
  the ``2N`` off-chip links (§4.2);
* 2D-mesh chip: grid of 16-tile blocks with a corner switch per block and
  channels sized by the switch footprint (§4.3), pads on all four edges for
  ``4*sqrt(N)-4`` links;
* silicon interposer: two rows of chips flanking a common wiring channel
  (folded Clos, §4.4) or a direct chip grid (mesh).

Anchors reproduced (see tests/test_paper_claims.py):
  - 256-tile 128 KB folded-Clos chip: 132.9 mm^2 total, 44.6 mm^2 I/O;
  - 256-tile 128 KB mesh chip: 87.9 mm^2;
  - mesh switch-to-switch wires 1.7-3.5 mm (single cycle);
  - Clos tile->edge wires < 5.5 mm, all other on-chip wires <= 11.2 mm;
  - interposer channel fraction growing to ~42% for 16x512-tile systems,
    interposer wire delays ~1-8 ns.

A copy of ``repro.core.vlsi``: every constant and float is the
reference's.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core import params as P


def _cycles(delay_ns: float, clock_ghz: float = 1.0) -> int:
    return max(1, math.ceil(delay_ns * clock_ghz - 1e-9))


def tile_area_mm2(mem_kb: float) -> float:
    return P.CHIP.processor_area_mm2 + P.sram_area_mm2(mem_kb)


def switch_group_area_mm2(n_switches: int) -> float:
    """Staggered switch group with packing inefficiency (§5.1.2)."""
    if n_switches <= 0:
        return 0.0
    oh = 1.0 + P.CALIB.switch_group_overhead_per_log2 * math.log2(max(2, n_switches))
    return n_switches * P.CHIP.switch_area_mm2 * oh


def io_area_mm2(n_links: int) -> float:
    """Pad + driver area for ``n_links`` off-chip links (§5.0.1)."""
    signal_pads = n_links * P.CALIB.pads_per_offchip_link
    total_pads = signal_pads / (1.0 - P.CHIP.power_ground_frac)
    return total_pads * P.CHIP.io_pad_area_mm2


def wire_bundle_width_mm(n_wires: int, layers_per_direction: int = 2) -> float:
    """Channel width occupied by ``n_wires`` half-shielded signal wires."""
    return n_wires * P.CHIP.shielded_wire_pitch_mm / layers_per_direction


@dataclasses.dataclass(frozen=True)
class ChipArea:
    network: str
    n_tiles: int
    mem_kb: int
    tiles_mm2: float
    edge_switch_mm2: float
    switch_group_mm2: float
    channel_wire_mm2: float
    io_mm2: float
    core_w_mm: float
    core_h_mm: float
    # latency inputs for the performance model (§5.1)
    tile_wire_mm: float            # tile <-> edge switch
    l1_wire_mm: float              # edge <-> stage-2 (clos) / switch <-> switch (mesh)
    l2_onchip_wire_mm: float       # stage-2 <-> pad column (clos only)

    @property
    def core_mm2(self) -> float:
        return self.core_w_mm * self.core_h_mm

    @property
    def total_mm2(self) -> float:
        return self.core_mm2 + self.io_mm2

    @property
    def interconnect_mm2(self) -> float:
        """Switch groups + inter-switch channel wiring (the paper's Fig. 6
        'interconnect'; excludes I/O and bounding-box slack)."""
        return self.edge_switch_mm2 + self.switch_group_mm2 + self.channel_wire_mm2

    @property
    def interconnect_frac(self) -> float:
        return self.interconnect_mm2 / self.total_mm2

    @property
    def io_frac(self) -> float:
        return self.io_mm2 / self.total_mm2

    @property
    def economical(self) -> bool:
        return P.CHIP.econ_area_min_mm2 <= self.total_mm2 <= P.CHIP.econ_area_max_mm2

    # -- link latencies in cycles (1 GHz clock, 155 ps/mm repeated wire) ------
    def _wire_cycles(self, length_mm: float) -> int:
        return _cycles(length_mm * P.CHIP.wire_delay_ps_per_mm / 1000.0)

    @property
    def t_tile_cycles(self) -> int:
        return self._wire_cycles(self.tile_wire_mm)

    @property
    def l1_cycles(self) -> int:
        return self._wire_cycles(self.l1_wire_mm)

    @property
    def l2_onchip_cycles(self) -> int:
        return self._wire_cycles(self.l2_onchip_wire_mm) if self.l2_onchip_wire_mm else 0


def clos_chip(n_tiles: int, mem_kb: int) -> ChipArea:
    """Folded-Clos chip floorplan (§4.2, Fig. 2a)."""
    if n_tiles < 16 or n_tiles > 512:
        raise ValueError("clos chip supports 16..512 tiles")
    t_area = tile_area_mm2(mem_kb)
    # leaf group: 16 tiles + 1 edge switch, square footprint
    leaf = 16 * t_area + P.CHIP.switch_area_mm2
    w = h = math.sqrt(leaf)
    tile_wire = w / 2.0

    n_groups = n_tiles // 16
    n_stage2 = n_groups if n_tiles > 16 else 0
    n_stage3 = max(0, n_tiles // 32)

    levels = int(round(math.log2(n_groups)))  # doubling steps above the leaf
    onchip_pitch = P.CHIP.shielded_wire_pitch_mm
    channel_wire_area = 0.0
    switch_groups_area = 0.0

    # distribute stage-2 switches over the quadrant-centre groups of the top
    # recursion level; the stage-3 bank sits at the chip centre (§4.2).
    for lvl in range(1, levels + 1):
        n_nodes = n_groups >> lvl                 # H-tree nodes at this level
        leaves_below = 1 << lvl                   # leaf groups below one node
        # wires crossing this node's channel: all up-links of the edge
        # switches below it (16 links x 18 wires each), on 2 layer pairs.
        wires = leaves_below * 16 * P.CHIP.wires_per_link_onchip
        wchan = wire_bundle_width_mm(wires)
        # switch group at this node: stage-2 switches allocated evenly to the
        # top two levels (quadrant centres), stage-3 bank at the very top.
        if lvl == levels:
            grp = switch_group_area_mm2(n_stage3)
            s2_here = n_stage2 - (n_stage2 // 2 if levels > 1 else 0)
            grp += switch_group_area_mm2(s2_here)
            # I/O routing wires to the pad column also cross the top channel
            wchan += wire_bundle_width_mm(2 * n_tiles * P.CHIP.wires_per_link_offchip)
        elif lvl == levels - 1:
            grp = switch_group_area_mm2((n_stage2 // 2) // max(1, n_nodes))
            grp *= 1  # per node
        else:
            grp = 0.0
        # grow the bounding box: alternate dimensions (H-tree)
        grp_w = grp / max(h, 1e-9)                # group squeezed along channel
        if w <= h:
            w, h = 2 * w + wchan + grp_w, h
        else:
            w, h = w, 2 * h + wchan + grp_w
        # channel wire area: arms span between sub-group centres (half the
        # node extent); dedicated channels use all 4 routing layers (M3-M6).
        arm = max(w, h) / 2.0
        channel_wire_area += n_nodes * 2.0 * arm * wire_bundle_width_mm(
            leaves_below * 16 * P.CHIP.wires_per_link_onchip,
            layers_per_direction=4)
        switch_groups_area += n_nodes * grp

    io = io_area_mm2(2 * n_tiles)
    l1_wire = max(w, h) / 2.0                     # leaf centre -> switch group
    l2_wire = max(w, h) / 4.0                     # stage group -> pad column
    return ChipArea(
        network="clos", n_tiles=n_tiles, mem_kb=mem_kb,
        tiles_mm2=n_tiles * t_area,
        edge_switch_mm2=n_groups * P.CHIP.switch_area_mm2,
        switch_group_mm2=switch_groups_area,
        channel_wire_mm2=channel_wire_area,
        io_mm2=io, core_w_mm=w, core_h_mm=h,
        tile_wire_mm=tile_wire, l1_wire_mm=l1_wire, l2_onchip_wire_mm=l2_wire,
    )


def mesh_chip(n_tiles: int, mem_kb: int) -> ChipArea:
    """2D-mesh chip floorplan (§4.3, Fig. 2b)."""
    if n_tiles < 16:
        raise ValueError("mesh chip needs at least one block")
    t_area = tile_area_mm2(mem_kb)
    block = 16 * t_area + P.CHIP.switch_area_mm2
    block_side = math.sqrt(block)
    n_sw = n_tiles // 16
    side = int(round(math.sqrt(n_sw)))
    if side * side == n_sw:
        rows = cols = side
    else:
        side = int(round(math.sqrt(n_sw / 2)))
        rows, cols = side, 2 * side
    sw_side = math.sqrt(P.CHIP.switch_area_mm2)
    link_wires = P.CALIB.mesh_links_per_direction * P.CHIP.wires_per_link_onchip
    chan = sw_side + wire_bundle_width_mm(link_wires)
    w = cols * block_side + cols * chan
    h = rows * block_side + rows * chan
    n_links_out = 4 * int(round(math.sqrt(n_tiles))) - 4
    io = io_area_mm2(n_links_out)
    # channel wiring between switches
    channel_wire_area = (
        (rows * (cols - 1) + cols * (rows - 1))
        * block_side * wire_bundle_width_mm(link_wires))
    return ChipArea(
        network="mesh", n_tiles=n_tiles, mem_kb=mem_kb,
        tiles_mm2=n_tiles * t_area,
        edge_switch_mm2=n_sw * P.CHIP.switch_area_mm2,
        switch_group_mm2=0.0,
        channel_wire_mm2=channel_wire_area,
        io_mm2=io, core_w_mm=w, core_h_mm=h,
        tile_wire_mm=block_side / 2.0, l1_wire_mm=block_side + chan,
        l2_onchip_wire_mm=0.0,
    )


def chip(network: str, n_tiles: int, mem_kb: int) -> ChipArea:
    return clos_chip(n_tiles, mem_kb) if network == "clos" else mesh_chip(n_tiles, mem_kb)


# ---------------------------------------------------------------------------
# Silicon interposer (§4.4, §5.1.3, Fig. 4/7)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class InterposerModel:
    network: str
    n_chips: int
    chip: ChipArea
    channel_mm2: float
    total_mm2: float
    min_wire_ns: float
    max_wire_ns: float

    @property
    def channel_frac(self) -> float:
        return self.channel_mm2 / self.total_mm2

    @property
    def avg_wire_ns(self) -> float:
        return 0.5 * (self.min_wire_ns + self.max_wire_ns)

    def link_cycles(self, which: str = "avg") -> int:
        ns = {"min": self.min_wire_ns, "max": self.max_wire_ns,
              "avg": self.avg_wire_ns}[which]
        return _cycles(ns)


def interposer(network: str, n_chips: int, tiles_per_chip: int,
               mem_kb: int) -> InterposerModel:
    c = chip(network, tiles_per_chip, mem_kb)
    chip_w = math.sqrt(c.total_mm2)           # packaged chip treated square
    chip_h = chip_w
    delay = P.INTERPOSER.wire_delay_ps_per_mm / 1000.0  # ns/mm
    if network == "mesh":
        # chips tiled in a grid; adjacent pads at near-constant separation
        rows = int(round(math.sqrt(n_chips))) or 1
        cols = max(1, n_chips // rows)
        gap = 1.0  # mm between adjacent chips
        total = (cols * (chip_w + gap)) * (rows * (chip_h + gap))
        wire_ns = gap * delay  # ~0.09 ns, constant (§5.1.3)
        return InterposerModel(network, n_chips, c, channel_mm2=0.0,
                               total_mm2=total, min_wire_ns=wire_ns,
                               max_wire_ns=wire_ns)
    # folded Clos: two rows of chips flanking a common wiring channel whose
    # height is the total pitch of the wires connecting one chip (2N links x
    # 10 wires); two-chip systems use direct point-to-point wiring instead.
    per_chip_wires = 2 * tiles_per_chip * P.INTERPOSER.wires_per_link
    if n_chips <= 2:
        chan_h = 1.0
    else:
        chan_h = per_chip_wires * P.INTERPOSER.shielded_wire_pitch_mm
    cols = max(1, (n_chips + 1) // 2)
    width = cols * chip_w
    total = width * (2 * chip_h + chan_h)
    channel = width * chan_h
    min_ns = (chip_w + chan_h) * delay
    max_ns = (width + chan_h) * delay
    return InterposerModel(network, n_chips, c, channel_mm2=channel,
                           total_mm2=total, min_wire_ns=min_ns, max_wire_ns=max_ns)
