"""Interconnect topologies (paper §2, Figure 1).

Two network families are modelled:

* :class:`FoldedClos` -- built from degree-32 crossbar switches.  Edge
  (stage-1) switches connect 16 tiles each and use their remaining 16 links
  upward.  Stage-2 switches connect 16 edge switches downward and present 16
  links upward (off-chip).  A bank of stage-3 "system core" switches
  (contributed pro-rata by every chip) joins multiple chips; all stage-2 <->
  stage-3 links cross the silicon interposer (paper §4.2: they are routed to
  I/O pads even when both endpoints share a chip).

* :class:`Mesh2D` -- blocks of 16 tiles per switch arranged in a square
  grid; chips tile the interposer and the grid extends directly across chip
  boundaries.

Both classes expose the quantities the latency model (§6.3) needs for every
source/destination tile pair: the switch-path length ``d(s,t)``, the list of
inter-switch links with their kind (on-chip stage level or interposer
crossing), and whether the path crosses a chip boundary (for the
serialisation term).  They also provide nearest-first tile orderings, which
is how an emulation of ``n`` tiles out of a larger machine is populated
(Fig. 9 sweeps emulation size inside 1,024- and 4,096-tile systems).

A copy of ``repro.core.topology``: every constant and float is the
reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator

from repro_torch.core import params as P


@dataclasses.dataclass(frozen=True)
class Link:
    """One inter-switch link on a message path."""
    kind: str          # "l1" (edge<->stage2), "l2" (stage2<->stage3), "mesh", "chip"
    on_chip: bool


@dataclasses.dataclass(frozen=True)
class Path:
    """A shortest path between two tiles, as the latency model sees it."""
    d: int                       # number of inter-switch links = |links|
    links: tuple[Link, ...]
    inter_chip: bool             # does the path cross a chip boundary?

    @property
    def n_switches(self) -> int:
        return self.d + 1


def _check_pow2(n: int, what: str) -> None:
    if n <= 0 or (n & (n - 1)) != 0:
        raise ValueError(f"{what} must be a positive power of two, got {n}")


class FoldedClos:
    """A folded-Clos system of ``n_tiles`` built from ``tiles_per_chip`` chips.

    Supports single-chip systems of 16..512 tiles and multi-chip systems of
    up to 16 chips (three switching stages, the paper's largest evaluated
    configuration of 4,096 tiles).
    """

    def __init__(self, n_tiles: int, tiles_per_chip: int = P.TILES_PER_CHIP):
        _check_pow2(n_tiles, "n_tiles")
        _check_pow2(tiles_per_chip, "tiles_per_chip")
        if n_tiles < P.TILES_PER_EDGE_SWITCH:
            raise ValueError("need at least one edge switch worth of tiles")
        if tiles_per_chip > 512:
            raise ValueError("chips beyond 512 tiles exceed economical area (Fig. 5)")
        self.n_tiles = n_tiles
        self.tiles_per_chip = min(tiles_per_chip, n_tiles)
        self.n_chips = max(1, n_tiles // self.tiles_per_chip)
        if self.n_chips > 16:
            raise ValueError(
                "three-stage folded Clos supports at most 16 chips (4,096 tiles)")
        self.t_edge = P.TILES_PER_EDGE_SWITCH

    # -- structural inventory -------------------------------------------------
    @property
    def n_edge_switches(self) -> int:
        return self.n_tiles // self.t_edge

    @property
    def n_stage2_switches(self) -> int:
        # one stage-2 switch per edge switch (16 down / 16 up), paper Fig. 1c.
        return self.n_edge_switches if self.n_tiles > self.t_edge else 0

    @property
    def n_stage3_switches(self) -> int:
        if self.n_chips == 1:
            return 0
        # every stage-2 up-link terminates on a stage-3 switch of degree 32
        return self.n_stage2_switches * (P.SWITCH_DEGREE // 2) // P.SWITCH_DEGREE

    @property
    def n_switches(self) -> int:
        return self.n_edge_switches + self.n_stage2_switches + self.n_stage3_switches

    @property
    def diameter_stages(self) -> int:
        if self.n_tiles <= self.t_edge:
            return 1
        return 2 if self.n_chips == 1 else 3

    # -- addressing -----------------------------------------------------------
    def chip_of(self, tile: int) -> int:
        return tile // self.tiles_per_chip

    def edge_switch_of(self, tile: int) -> int:
        return tile // self.t_edge

    # -- paths ----------------------------------------------------------------
    def path(self, s: int, t: int) -> Path:
        """Shortest path between tiles ``s`` and ``t`` (§6.3 d(s,t))."""
        if not (0 <= s < self.n_tiles and 0 <= t < self.n_tiles):
            raise ValueError("tile index out of range")
        if self.edge_switch_of(s) == self.edge_switch_of(t):
            return Path(0, (), False)
        if self.chip_of(s) == self.chip_of(t):
            l1 = Link("l1", True)
            return Path(2, (l1, l1), False)
        # inter-chip: edge -> s2 -> s3 -> s2' -> edge'; the two middle links
        # traverse the interposer (§4.2).
        l1 = Link("l1", True)
        l2 = Link("l2", False)
        return Path(4, (l1, l2, l2, l1), True)

    def default_client(self) -> int:
        """Client tile position: immaterial for the symmetric folded Clos."""
        return 0

    def nearest_tiles(self, client: int = 0) -> Iterator[int]:
        """Tiles in non-decreasing path length from ``client`` (emulation fill
        order used by the Fig. 9/10 sweeps)."""
        same_edge, same_chip, remote = [], [], []
        for t in range(self.n_tiles):
            if self.edge_switch_of(t) == self.edge_switch_of(client):
                same_edge.append(t)
            elif self.chip_of(t) == self.chip_of(client):
                same_chip.append(t)
            else:
                remote.append(t)
        yield from same_edge
        yield from same_chip
        yield from remote


class Mesh2D:
    """A 2D-mesh system: square grid of switches, 16 tiles per switch.

    Chips are square sub-grids tiled on the interposer; grid links that cross
    a chip boundary are interposer links (constant 0.09 ns wire, §5.1.3).
    """

    def __init__(self, n_tiles: int, tiles_per_chip: int = P.TILES_PER_CHIP):
        _check_pow2(n_tiles, "n_tiles")
        self.n_tiles = n_tiles
        self.tiles_per_chip = min(tiles_per_chip, n_tiles)
        self.n_chips = max(1, n_tiles // self.tiles_per_chip)
        self.t_edge = P.TILES_PER_EDGE_SWITCH
        n_sw = n_tiles // self.t_edge
        side = int(round(math.sqrt(n_sw)))
        if side * side != n_sw:
            # non-square tile counts (e.g. 32, 128, 512 tiles) use a 2:1 grid
            side = int(round(math.sqrt(n_sw / 2)))
            if 2 * side * side != n_sw:
                raise ValueError(f"cannot arrange {n_sw} switches in a (2:1) grid")
            self.rows, self.cols = side, 2 * side
        else:
            self.rows = self.cols = side
        chip_sw = self.tiles_per_chip // self.t_edge
        chip_side = int(round(math.sqrt(chip_sw)))
        if chip_side * chip_side == chip_sw:
            self.chip_rows, self.chip_cols = chip_side, chip_side
        else:
            chip_side = int(round(math.sqrt(chip_sw / 2)))
            self.chip_rows, self.chip_cols = chip_side, 2 * chip_side

    @property
    def n_switches(self) -> int:
        return self.rows * self.cols

    def switch_of(self, tile: int) -> tuple[int, int]:
        s = tile // self.t_edge
        return divmod(s, self.cols)

    def chip_of(self, tile: int) -> tuple[int, int]:
        r, c = self.switch_of(tile)
        return (r // self.chip_rows, c // self.chip_cols)

    def path(self, s: int, t: int) -> Path:
        (r1, c1), (r2, c2) = self.switch_of(s), self.switch_of(t)
        links: list[Link] = []
        # dimension-ordered (X then Y) shortest-path route
        r, c = r1, c1
        while c != c2:
            nc = c + (1 if c2 > c else -1)
            links.append(Link("mesh", c // self.chip_cols == nc // self.chip_cols))
            c = nc
        while r != r2:
            nr = r + (1 if r2 > r else -1)
            links.append(Link("mesh", r // self.chip_rows == nr // self.chip_rows))
            r = nr
        inter_chip = any(not l.on_chip for l in links)
        return Path(len(links), tuple(links), inter_chip)

    def default_client(self) -> int:
        """Client tile at the grid centre: the natural placement for an
        emulation that grows outward (the paper does not fix the client's
        position; centre placement reproduces its 30-40% mesh overhead)."""
        centre = (self.rows // 2) * self.cols + self.cols // 2
        return centre * self.t_edge

    def nearest_tiles(self, client: int = 0) -> Iterator[int]:
        (r0, c0) = self.switch_of(client)
        order = sorted(
            range(self.n_switches),
            key=lambda s: (abs(s // self.cols - r0) + abs(s % self.cols - c0)),
        )
        for sw in order:
            base = sw * self.t_edge
            yield from range(base, base + self.t_edge)


def build(network: str, n_tiles: int, tiles_per_chip: int = P.TILES_PER_CHIP):
    if network == "clos":
        return FoldedClos(n_tiles, tiles_per_chip)
    if network == "mesh":
        return Mesh2D(n_tiles, tiles_per_chip)
    raise ValueError(f"unknown network {network!r}")
