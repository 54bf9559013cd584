"""Emulation-scheme performance model (paper §2.1, §6.2, §7.2, §7.3).

A sequential program is characterised by its instruction mix: non-memory
instructions, local-memory accesses (program/stack/constants -- always in the
tile's local SRAM, single cycle) and global-memory accesses (static data +
heap -- served by DRAM on the sequential machine, by the emulated distributed
memory on the parallel machine).

Global accesses on the parallel machine are rewritten as communication
sequences (§2.1):

    LOAD  dest, addr  ->  SEND c,READ; SEND c,addr; RECEIVE dest   (+2 instrs)
    STORE value, addr ->  SEND c,WRITE; SEND c,addr; SEND c,value  (+3 instrs)

so each global access costs its extra issue cycles plus the blocking
round-trip through the network (both loads and stores complete before the
next access issues -- the paper's sequential-consistency measurement loop).

A copy of ``repro.core.emulation``: every price and sweep is the
reference's float for float, in cycles of :data:`repro_torch.core.params.
CHIP`'s clock.  The serving scheduler ranks admissions with its host and
spill tiers and :func:`admission_score`.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core import dram as dram_mod
from repro_torch.core import latency as lat_mod
from repro_torch.core import params as P

#: §2.1 communication-sequence instruction overheads (§7.3).
LOAD_EXTRA_INSTRS = 2
STORE_EXTRA_INSTRS = 3


@dataclasses.dataclass(frozen=True)
class InstructionMix:
    """Dynamic instruction mix of a benchmark (paper Fig. 8)."""
    name: str
    non_mem: float
    local: float
    global_: float
    load_frac: float = 0.6          # loads as a fraction of global accesses

    def __post_init__(self):
        total = self.non_mem + self.local + self.global_
        if abs(total - 1.0) > 1e-9:
            raise ValueError(f"instruction mix must sum to 1, got {total}")

    @property
    def store_frac(self) -> float:
        return 1.0 - self.load_frac


#: The two benchmark mixes (paper Fig. 8; local fixed at 20%, global 10-20%).
DHRYSTONE = InstructionMix("dhrystone", non_mem=0.60, local=0.20, global_=0.20)
COMPILER = InstructionMix("compiler", non_mem=0.70, local=0.20, global_=0.10)


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Hot-page cache in the client tile's local SRAM (the emem_vm cache).

    A global access that hits the cache is an ordinary 1-cycle local SRAM
    access -- no §2.1 communication sequence is issued.  The hit rate follows
    a hyperbolic working-set curve ``h = C / (C + C_half)``: ``C_half`` is
    the cache size that captures half the accesses (the hot-set half-size).
    It is a fitted stand-in for a measured reuse profile: monotone in the
    capacity, 0 at size 0, asymptotic to 1, matching the shape of the
    executable cache's measured counters (``EMemVM.counters``).
    """
    capacity_kb: float
    hot_set_half_kb: float = 64.0

    def hit_rate(self) -> float:
        if self.capacity_kb <= 0.0:
            return 0.0
        return self.capacity_kb / (self.capacity_kb + self.hot_set_half_kb)


@dataclasses.dataclass(frozen=True)
class HostTierConfig:
    """A host-memory (CPU DRAM) tier one PCIe hop below the emulated pool.

    Extends the §7.2 access model one level down the hierarchy, the same
    move the paper makes one level up: pages evicted from the small
    distributed memories live across PCIe, and an access that faults on a
    host-resident page pays a *page-granular* round trip (latency plus two
    page transfers -- the victim's write-back and the faulted page's read)
    on top of the ordinary communication sequence.

    ``host_frac`` is the fraction of cache-missing global accesses that
    fault to host -- the swap/churn knob a workload measures (cf. the
    serving engine's ``swap_out_pages`` / access counters).
    """
    pcie_gbps: float = 16.0          # effective per-direction bandwidth
    pcie_latency_us: float = 2.0     # software + link round-trip latency
    page_kb: float = 4.0             # swap granularity (one frame)
    host_frac: float = 0.0           # misses served by a host-resident page

    def __post_init__(self):
        if not (0.0 <= self.host_frac <= 1.0):
            raise ValueError("host_frac must be in [0, 1]")
        if self.pcie_gbps <= 0.0:
            raise ValueError("pcie_gbps must be positive")

    def roundtrip_cycles(self, clock_ghz: float = P.CHIP.clock_ghz) -> float:
        """Cycles to fault one page in (and one victim out) over PCIe."""
        xfer_s = 2 * self.page_kb * 1024 / (self.pcie_gbps * 1e9)
        return (self.pcie_latency_us * 1e-6 + xfer_s) * clock_ghz * 1e9

    def page_in_cycles(self, clock_ghz: float = P.CHIP.clock_ghz) -> float:
        """Cycles to move one page host->device (one direction, no victim
        write-back): the per-page price of a planned swap-in, as opposed to
        the demand-fault round trip of :meth:`roundtrip_cycles`."""
        xfer_s = self.page_kb * 1024 / (self.pcie_gbps * 1e9)
        return (self.pcie_latency_us * 1e-6 + xfer_s) * clock_ghz * 1e9


@dataclasses.dataclass(frozen=True)
class SpillTierConfig:
    """The third tier: a file/bytes-backed spill store one hop below host
    DRAM (disk / NVMe / remote memory).

    Extends the hierarchy the same way :class:`HostTierConfig` does -- each
    tier spills to the next-cheaper one under a cost model instead of
    falling off the hierarchy (the recompute cliff this tier exists to
    price away).  A page parked here is *two* hops from the device: a
    restore pays the spill read (this config) plus the host->device PCIe
    transfer (:class:`HostTierConfig`), which is exactly how
    :func:`admission_score` prices a two-hop resume.

    ``spill_frac`` is the fraction of host-tier faults whose page was
    demoted on down to the spill store -- the host-pressure knob a
    workload measures (cf. the BlockManager's ``spill_out_pages`` /
    ``swap_out_pages`` counters).

    Defaults model a remote-memory / fast-NVMe-read-class device (~10 us
    to first byte): slow enough that the extra hop visibly demotes a
    two-hop resume below an all-host one in :func:`admission_score`, fast
    enough that it still beats re-prefilling the pages' tokens -- the
    inequality that makes the tier worth having at all.
    """
    read_gbps: float = 3.0           # sequential read bandwidth (NVMe-class)
    write_gbps: float = 1.5          # sequential write bandwidth
    latency_us: float = 10.0         # per-op software + media latency
    page_kb: float = 4.0             # spill granularity (one frame)
    spill_frac: float = 0.0          # host faults served from the spill tier

    def __post_init__(self):
        if not (0.0 <= self.spill_frac <= 1.0):
            raise ValueError("spill_frac must be in [0, 1]")
        if self.read_gbps <= 0.0 or self.write_gbps <= 0.0:
            raise ValueError("spill bandwidths must be positive")

    def page_in_cycles(self, clock_ghz: float = P.CHIP.clock_ghz) -> float:
        """Cycles to promote one page SPILL -> HOST (the extra first hop of
        a two-hop restore; the HOST -> DEVICE leg is priced by
        :meth:`HostTierConfig.page_in_cycles`)."""
        xfer_s = self.page_kb * 1024 / (self.read_gbps * 1e9)
        return (self.latency_us * 1e-6 + xfer_s) * clock_ghz * 1e9

    def page_out_cycles(self, clock_ghz: float = P.CHIP.clock_ghz) -> float:
        """Cycles to demote one page HOST -> SPILL (the demotion policy's
        per-page price under host pressure)."""
        xfer_s = self.page_kb * 1024 / (self.write_gbps * 1e9)
        return (self.latency_us * 1e-6 + xfer_s) * clock_ghz * 1e9

    def roundtrip_cycles(self, clock_ghz: float = P.CHIP.clock_ghz) -> float:
        """Cycles to fault one page up from spill AND demote a victim down
        -- the demand-fault price at a full host tier."""
        return self.page_in_cycles(clock_ghz) + self.page_out_cycles(clock_ghz)


def fit_hot_set_kb(traces) -> float:
    """Fit :attr:`CacheConfig.hot_set_half_kb` from measured cache traces.

    ``traces`` is an iterable of dicts, each pairing a cache capacity with
    the hit/miss counters measured at that capacity -- i.e.
    ``{**EMemVM.counters(), "capacity_kb": <cache size>}`` (``hit_rate`` is
    used directly when ``hits``/``misses`` are absent).

    The working-set model is ``h = C / (C + C_half)``, so each trace gives
    a point estimate ``C_half = C * (1 - h) / h``; the fit is the
    access-count-weighted average of the point estimates (least squares in
    ``C_half`` under per-access noise).  Traces with h == 0 carry no finite
    estimate and are skipped; with no usable trace the 64 KB default is
    returned.
    """
    default = CacheConfig.__dataclass_fields__["hot_set_half_kb"].default
    num = den = 0.0
    for tr in traces:
        cap = float(tr["capacity_kb"])
        if cap <= 0.0:
            continue
        if "hits" in tr or "misses" in tr:
            hits = float(tr.get("hits", 0))
            total = hits + float(tr.get("misses", 0))
            if total <= 0:
                continue
            h, weight = hits / total, total
        else:
            h, weight = float(tr["hit_rate"]), 1.0
        if h <= 0.0:
            continue                     # C_half estimate is unbounded
        num += weight * cap * (1.0 - h) / h
        den += weight
    return num / den if den else default


def synthetic_mix(global_frac: float, local_frac: float = 0.20) -> InstructionMix:
    """Synthetic sequences with a swept global fraction (Fig. 11)."""
    return InstructionMix(f"synthetic-g{global_frac:.2f}",
                          non_mem=1.0 - local_frac - global_frac,
                          local=local_frac, global_=global_frac)


@dataclasses.dataclass(frozen=True)
class SequentialMachine:
    """Baseline: same processor class + DDR3 DRAM (paper §6.1)."""
    dram: dram_mod.DRAMSystem = dram_mod.DRAMSystem()
    clock_ghz: float = P.CHIP.clock_ghz

    def global_access_cycles(self) -> float:
        return 1.0 + self.dram.random_access_latency_cycles(self.clock_ghz)

    def cycles_per_instruction(self, mix: InstructionMix) -> float:
        return (mix.non_mem + mix.local) * 1.0 + mix.global_ * self.global_access_cycles()


class EmulationMachine:
    """The parallel machine running the same program with an emulated memory.

    With a :class:`CacheConfig` the access model is cache-aware: a hit is a
    1-cycle local SRAM access, a miss pays the full communication sequence
    (issue overhead + network round trip), weighted by the hit rate.  With
    a :class:`HostTierConfig` the model is additionally *residency-aware*:
    a ``host_frac`` fraction of the misses fault on a page swapped out to
    host memory and pay the page-granular PCIe round trip on top.  With a
    :class:`SpillTierConfig` it is three-tier: a ``spill_frac`` fraction of
    those host faults find their page demoted one level further down and
    pay the spill round trip as well (the two-hop promotion).
    """

    def __init__(self, sys: lat_mod.SystemConfig, emulation_tiles: int,
                 cache: CacheConfig | None = None,
                 host: HostTierConfig | None = None,
                 spill: SpillTierConfig | None = None):
        self.sys = sys
        self.model = lat_mod.LatencyModel(sys)
        self.emulation_tiles = min(emulation_tiles, sys.n_tiles)
        self.cache = cache
        self.host = host
        self.spill = spill

    def global_access_cycles(self, mix: InstructionMix) -> float:
        rt = self.model.mean_access_latency(self.emulation_tiles)
        issue = (1.0
                 + mix.load_frac * LOAD_EXTRA_INSTRS
                 + mix.store_frac * STORE_EXTRA_INSTRS)
        miss_cycles = issue + rt
        if self.host is not None and self.host.host_frac > 0.0:
            fault = self.host.roundtrip_cycles(P.CHIP.clock_ghz)
            if self.spill is not None and self.spill.spill_frac > 0.0:
                fault += self.spill.spill_frac * \
                    self.spill.roundtrip_cycles(P.CHIP.clock_ghz)
            miss_cycles += self.host.host_frac * fault
        if self.cache is None:
            return miss_cycles
        h = self.cache.hit_rate()
        return h * 1.0 + (1.0 - h) * miss_cycles

    def cycles_per_instruction(self, mix: InstructionMix) -> float:
        return ((mix.non_mem + mix.local) * 1.0
                + mix.global_ * self.global_access_cycles(mix))


def slowdown(mix: InstructionMix, network: str, system_tiles: int,
             emulation_tiles: int, mem_kb: int = 256,
             dram_capacity_gb: int | None = None,
             cache: CacheConfig | None = None,
             host: HostTierConfig | None = None,
             spill: SpillTierConfig | None = None) -> float:
    """Relative slowdown of the emulation vs the sequential machine (Fig. 10).

    The DRAM baseline capacity defaults to the capacity of the emulated
    memory, so both machines offer the same amount of global storage.
    """
    if dram_capacity_gb is None:
        cap_bytes = emulation_tiles * mem_kb * 1024
        dram_capacity_gb = max(1, round(cap_bytes / 2**30))
    seq = SequentialMachine(dram=dram_mod.DRAMSystem(capacity_gb=dram_capacity_gb))
    par = EmulationMachine(
        lat_mod.SystemConfig(network=network, n_tiles=system_tiles, mem_kb=mem_kb),
        emulation_tiles, cache=cache, host=host, spill=spill)
    return par.cycles_per_instruction(mix) / seq.cycles_per_instruction(mix)


def fig10_sweep(system_tiles: int, mem_kb: int = 256) -> dict:
    """Fig. 10: benchmark slowdown vs emulation size, both networks."""
    sizes, n = [], 16
    while n <= system_tiles:
        sizes.append(n)
        n *= 2
    out: dict = {"sizes": sizes}
    for net in ("clos", "mesh"):
        for mix in (DHRYSTONE, COMPILER):
            out[f"{net}/{mix.name}"] = [
                slowdown(mix, net, system_tiles, s, mem_kb) for s in sizes]
    return out


def fig11_sweep(system_tiles: int, emulation_tiles: int | None = None,
                mem_kb: int = 256) -> dict:
    """Fig. 11: slowdown vs global-access fraction (0-50%), local fixed 20%."""
    emulation_tiles = emulation_tiles or system_tiles
    fracs = [i / 100.0 for i in range(0, 51, 5)]
    out: dict = {"global_frac": fracs}
    for net in ("clos", "mesh"):
        vals = []
        for g in fracs:
            if g == 0.0:
                vals.append(1.0)
                continue
            vals.append(slowdown(synthetic_mix(g), net, system_tiles,
                                 emulation_tiles, mem_kb))
        out[net] = vals
    return out


def fig_cache_sweep(system_tiles: int, emulation_tiles: int | None = None,
                    mem_kb: int = 256, mix: InstructionMix = DHRYSTONE,
                    cache_sizes_kb: Sequence[float] = (0, 4, 8, 16, 32, 64,
                                                      128, 256, 512),
                    networks: tuple[str, ...] = ("clos", "mesh")) -> dict:
    """Slowdown vs hot-page cache size (the emem_vm extension of Fig. 10).

    Returns {"cache_kb": [...], "hit_rate": [...], "<net>": [slowdowns]};
    slowdown is monotone non-increasing in cache size by construction.
    """
    emulation_tiles = emulation_tiles or system_tiles
    caches = [CacheConfig(c) for c in cache_sizes_kb]
    out: dict = {"cache_kb": list(cache_sizes_kb),
                 "hit_rate": [c.hit_rate() for c in caches]}
    for net in networks:
        out[net] = [slowdown(mix, net, system_tiles, emulation_tiles, mem_kb,
                             cache=c) for c in caches]
    return out


def fig_swap_sweep(system_tiles: int, emulation_tiles: int | None = None,
                   mem_kb: int = 256, mix: InstructionMix = DHRYSTONE,
                   host_fracs: Sequence[float] = (0.0, 0.001, 0.005, 0.01,
                                                  0.05, 0.1),
                   host: HostTierConfig = HostTierConfig(),
                   networks: tuple[str, ...] = ("clos", "mesh")) -> dict:
    """Slowdown vs the fraction of misses faulting to the host tier (the
    residency extension of the Fig. 10 family).

    Returns ``{"host_frac": [...], "fault_cycles": c, "<net>": [...]}`` --
    slowdown is monotone non-decreasing in ``host_frac`` by construction,
    and the ``host_frac=0`` point reproduces the device-only model exactly
    (the two-tier model embeds the one-tier one).
    """
    emulation_tiles = emulation_tiles or system_tiles
    out: dict = {"host_frac": list(host_fracs),
                 "fault_cycles": host.roundtrip_cycles(P.CHIP.clock_ghz)}
    for net in networks:
        out[net] = [
            slowdown(mix, net, system_tiles, emulation_tiles, mem_kb,
                     host=dataclasses.replace(host, host_frac=f))
            for f in host_fracs]
    return out


def fig_tier_sweep(system_tiles: int, emulation_tiles: int | None = None,
                   mem_kb: int = 256, mix: InstructionMix = DHRYSTONE,
                   host_frac: float = 0.01,
                   spill_fracs: Sequence[float] = (0.0, 0.05, 0.1, 0.25,
                                                   0.5, 1.0),
                   host: HostTierConfig = HostTierConfig(),
                   spill: SpillTierConfig = SpillTierConfig(),
                   networks: tuple[str, ...] = ("clos", "mesh")) -> dict:
    """Slowdown vs the fraction of host faults served from the spill tier
    (the three-tier extension of the Fig. 10 family, at a fixed
    ``host_frac`` of misses faulting off-device).

    Returns ``{"spill_frac": [...], "host_fault_cycles": c_h,
    "spill_fault_cycles": c_s, "<net>": [...]}`` -- slowdown is monotone
    non-decreasing in ``spill_frac`` by construction, and the
    ``spill_frac=0`` point reproduces the two-tier (host-only) model
    exactly: each tier's model embeds the one above it, which is the
    paper's emulation argument applied down the hierarchy.
    """
    emulation_tiles = emulation_tiles or system_tiles
    host = dataclasses.replace(host, host_frac=host_frac)
    out: dict = {"spill_frac": list(spill_fracs),
                 "host_fault_cycles": host.roundtrip_cycles(P.CHIP.clock_ghz),
                 "spill_fault_cycles":
                     spill.roundtrip_cycles(P.CHIP.clock_ghz)}
    for net in networks:
        out[net] = [
            slowdown(mix, net, system_tiles, emulation_tiles, mem_kb,
                     host=host,
                     spill=dataclasses.replace(spill, spill_frac=f))
            for f in spill_fracs]
    return out


#: default §7-model price of re-prefilling one token through the serving
#: model.  A stand-in FLOPs proxy: only the RATIO to the PCIe page cost
#: matters for ranking admissions, and for KV-style state the rebuild
#: (replaying the prefix through every layer) dwarfs a page transfer --
#: cf. :func:`swap_break_even_accesses`.
PREFILL_CYCLES_PER_TOKEN = 10_000.0


def admission_score(shared_tokens: int, swap_in_pages: int, page_slots: int,
                    host: HostTierConfig | None = None,
                    prefill_cycles_per_token: float = PREFILL_CYCLES_PER_TOKEN,
                    clock_ghz: float = P.CHIP.clock_ghz,
                    spill_in_pages: int = 0,
                    spill: SpillTierConfig | None = None) -> float:
    """Price an admission's residency terms into one score (cycles saved).

    The ways an admission can exploit memory that is already where the
    work needs it:

      * ``shared_tokens`` leading prompt tokens are backed by resident
        pages (retention pool or a live prefix) -- their prefill FLOPs are
        avoided outright;
      * a swap record exists: the resume skips re-prefilling the
        ``swap_in_pages * page_slots`` committed tokens but pays the PCIe
        transfer of those pages (:meth:`HostTierConfig.page_in_cycles`);
      * ``spill_in_pages`` of those pages were demoted to the spill tier
        under host pressure and pay the extra SPILL -> HOST hop
        (:meth:`SpillTierConfig.page_in_cycles`) on top of the PCIe leg --
        the *two-hop* restore, priced honestly so a mostly-spilled resume
        ranks below an all-host one of the same length (and a spilled
        resume still ranks far above a cold prefill, which is the whole
        point of the tier).

    A cold request scores 0; anything resident scores positive as long as
    a token's prefill outweighs its share of a page transfer (it does by
    orders of magnitude at production model sizes -- the same inequality
    :func:`swap_break_even_accesses` measures).  The score is a *ranking*
    signal for bounded-window admission reordering, not a latency estimate.
    """
    host = host if host is not None else HostTierConfig()
    saved = shared_tokens * prefill_cycles_per_token
    if swap_in_pages:
        saved += swap_in_pages * page_slots * prefill_cycles_per_token
        saved -= swap_in_pages * host.page_in_cycles(clock_ghz)
    if spill_in_pages:
        spill = spill if spill is not None else SpillTierConfig()
        saved -= spill_in_pages * spill.page_in_cycles(clock_ghz)
    return saved


def swap_break_even_accesses(host: HostTierConfig, rebuild_cycles: float,
                             clock_ghz: float = P.CHIP.clock_ghz) -> float:
    """Accesses per fault below which swapping beats recomputation.

    A preempted sequence can either park its pages on host (each later
    fault pays :meth:`HostTierConfig.roundtrip_cycles`) or drop them and
    pay ``rebuild_cycles`` once to recompute the state (the serving
    engine's re-prefill).  Swapping wins while
    ``faults * roundtrip < rebuild``; the returned count is that threshold
    -- large for KV-style state whose rebuild replays the whole prefix.
    """
    rt = host.roundtrip_cycles(clock_ghz)
    return rebuild_cycles / rt if rt > 0 else float("inf")


# ---------------------------------------------------------------------------
# Program binary size (§7.3)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class StaticBinaryProfile:
    """Static (not dynamic) instruction profile of a program binary.

    The compiler's own binary has ~3.4% of its instructions at global-access
    sites (static density is much lower than the 10% dynamic density because
    hot loops concentrate dynamic global accesses).
    """
    name: str = "compiler"
    global_load_sites: float = 0.022   # fraction of static instructions
    global_store_sites: float = 0.012

    def size_overhead(self) -> float:
        """Fractional binary-size increase from the §2.1 rewriting."""
        return (self.global_load_sites * LOAD_EXTRA_INSTRS
                + self.global_store_sites * STORE_EXTRA_INSTRS)


COMPILER_BINARY = StaticBinaryProfile()
