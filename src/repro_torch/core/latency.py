"""Network message-latency and emulated-memory access model (paper §6.3, §7.1).

Implements the paper's two message-latency equations over a system built from
the topology (:mod:`repro_torch.core.topology`) and floorplan
(:mod:`repro_torch.core.vlsi`) models:

    t_closed(s,t) = 2*t_tile + t_serial + (d(s,t)+1)*(t_open + t_switch*c_cont)
                    + sum_{l in p(s,t)} t_link(l)

    t_open(s,t)   = 2*t_tile + t_serial + (d(s,t)+1)*t_switch*c_cont
                    + sum_{l in p(s,t)} t_link(l)

All latencies are in cycles at the 1 GHz system clock.  Link latencies come
from the VLSI wire model: on-chip links are 1-2 cycles depending on length;
stage-2 <-> stage-3 links always traverse the interposer (paper §4.2) and take
1-8 cycles depending on the interposer span; mesh chip-to-chip hops cost the
constant 0.09 ns interposer wire (sub-cycle, rounded up to 1).

An emulated-memory access (paper §2.1) is a round trip: the request message
travels client -> owning tile, the tile's SRAM is accessed by the DMA engine,
and the response travels back.  Random addressing means routes are not
reusable, so both messages pay ``t_closed``.

A copy of ``repro.core.latency``, its caches included.
"""
from __future__ import annotations

import dataclasses
import math
from functools import lru_cache

from repro_torch.core import params as P
from repro_torch.core import topology as topo
from repro_torch.core import vlsi


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    """A modelled machine: network type, size, per-tile memory."""
    network: str = "clos"              # "clos" | "mesh"
    n_tiles: int = 1024
    tiles_per_chip: int = 256
    mem_kb: int = 256
    net: P.NetworkParams = P.NETWORK

    @property
    def n_chips(self) -> int:
        return max(1, self.n_tiles // self.tiles_per_chip)

    @property
    def sram_cycles(self) -> int:
        return max(1, math.ceil(P.SRAM.cycle_time_ns))

    @property
    def tile_capacity_bytes(self) -> int:
        return self.mem_kb * 1024

    def emulated_capacity_bytes(self, n_emulation_tiles: int) -> int:
        return n_emulation_tiles * self.tile_capacity_bytes


@lru_cache(maxsize=None)
def _chip_model(network: str, tiles_per_chip: int, mem_kb: int) -> vlsi.ChipArea:
    return vlsi.chip(network, tiles_per_chip, mem_kb)


@lru_cache(maxsize=None)
def _interposer_model(network: str, n_chips: int, tiles_per_chip: int,
                      mem_kb: int) -> vlsi.InterposerModel | None:
    if n_chips <= 1:
        return None
    return vlsi.interposer(network, n_chips, tiles_per_chip, mem_kb)


#: mean access latency (cycles) by (SystemConfig, emulation tiles, client)
_MEAN_ACCESS: dict = {}


class LatencyModel:
    """Evaluates the §6.3 equations for a :class:`SystemConfig`."""

    def __init__(self, sys: SystemConfig):
        self.sys = sys
        self.network = topo.build(sys.network, sys.n_tiles, sys.tiles_per_chip)
        self.chip = _chip_model(sys.network, min(sys.n_tiles, sys.tiles_per_chip),
                                sys.mem_kb)
        self.interposer = _interposer_model(
            sys.network, sys.n_chips, sys.tiles_per_chip, sys.mem_kb)

    # -- per-link latency -----------------------------------------------------
    def t_link(self, link: topo.Link) -> int:
        if link.kind == "l1":
            return self.chip.l1_cycles
        if link.kind == "l2":
            onchip = self.chip.l2_onchip_cycles
            inter = self.interposer.link_cycles("avg") if self.interposer else 0
            return onchip + inter
        if link.kind == "mesh":
            if link.on_chip:
                return self.chip.l1_cycles
            # constant 0.09 ns interposer hop (§5.1.3) + pad traversal
            return self.chip.l1_cycles + 1
        raise ValueError(f"unknown link kind {link.kind!r}")

    @property
    def t_tile(self) -> int:
        return self.chip.t_tile_cycles

    # -- message latency (§6.3) ----------------------------------------------
    def message_latency(self, s: int, t: int, route_open: bool = False) -> float:
        p = self.network.path(s, t)
        n = self.sys.net
        serial = n.t_serial_inter if p.inter_chip else n.t_serial_intra
        lat = 2 * self.t_tile + serial
        per_switch = n.t_switch * n.c_cont + (0 if route_open else n.t_open)
        lat += p.n_switches * per_switch
        lat += sum(self.t_link(l) for l in p.links)
        return float(lat)

    # -- emulated memory access (§2.1 / §7.1) ----------------------------------
    def access_latency(self, s: int, t: int) -> float:
        """Round-trip latency of one emulated READ/WRITE, client s, owner t."""
        req = self.message_latency(s, t, route_open=False)
        resp = self.message_latency(t, s, route_open=False)
        return req + self.sys.sram_cycles + resp

    def mean_access_latency(self, n_emulation_tiles: int,
                            client: int | None = None) -> float:
        """Average over uniformly random addresses distributed over the ``n``
        tiles nearest the client (the paper's Fig. 9 sweep).  A pure
        function of (system, n, client), kept in :data:`_MEAN_ACCESS` once
        computed: the Fig. 10-13 sweeps ask for the same few means hundreds
        of times."""
        if client is None:
            client = self.network.default_client()
        n = min(n_emulation_tiles, self.sys.n_tiles)
        key = (self.sys, n, client)
        if key not in _MEAN_ACCESS:
            _MEAN_ACCESS[key] = self._mean_access_latency(n, client)
        return _MEAN_ACCESS[key]

    def _mean_access_latency(self, n: int, client: int) -> float:
        tiles = []
        for t in self.network.nearest_tiles(client):
            tiles.append(t)
            if len(tiles) >= n:
                break
        total = sum(self.access_latency(client, t) for t in tiles)
        return total / len(tiles)


def mean_access_latency_ns(network: str, system_tiles: int, emulation_tiles: int,
                           mem_kb: int = 256,
                           tiles_per_chip: int = 256) -> float:
    sys = SystemConfig(network=network, n_tiles=system_tiles,
                       tiles_per_chip=tiles_per_chip, mem_kb=mem_kb)
    model = LatencyModel(sys)
    cycles = model.mean_access_latency(emulation_tiles)
    return cycles / P.CHIP.clock_ghz


def fig9_sweep(system_tiles: int, mem_kb: int = 256,
               networks: tuple[str, ...] = ("clos", "mesh")) -> dict:
    """Reproduce one panel of Fig. 9: mean access latency vs emulation size."""
    sizes = []
    n = 16
    while n <= system_tiles:
        sizes.append(n)
        n *= 2
    out = {"sizes": sizes}
    for net in networks:
        model = LatencyModel(SystemConfig(network=net, n_tiles=system_tiles,
                                          mem_kb=mem_kb))
        out[net] = [model.mean_access_latency(s) for s in sizes]
    return out
