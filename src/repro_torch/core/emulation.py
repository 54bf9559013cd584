"""The slice of the emulation-scheme cost model the scheduler prices
admissions with (a copy of ``repro.core.emulation``'s host and spill tiers
and :func:`admission_score`).

Pages evicted from the emulated pool live one PCIe hop below it (host
DRAM) and, under host pressure, one hop further down (the spill store).
The scheduler ranks admissions by the prefill cycles a resident prefix or
a swap record saves, net of the page transfers a resume pays.
"""
from __future__ import annotations

import dataclasses

#: clock of the emulated chip the cycle prices are counted in (the
#: reference's ``core.params.CHIP.clock_ghz``)
CHIP_CLOCK_GHZ = 1.0


@dataclasses.dataclass(frozen=True)
class HostTierConfig:
    """A host-memory (CPU DRAM) tier one PCIe hop below the emulated pool.

    An access that faults on a host-resident page pays a page-granular
    round trip (latency plus two page transfers -- the victim's write-back
    and the faulted page's read).  ``host_frac`` is the fraction of
    cache-missing global accesses that fault to host."""
    pcie_gbps: float = 16.0          # effective per-direction bandwidth
    pcie_latency_us: float = 2.0     # software + link round-trip latency
    page_kb: float = 4.0             # swap granularity (one frame)
    host_frac: float = 0.0           # misses served by a host-resident page

    def __post_init__(self):
        if not (0.0 <= self.host_frac <= 1.0):
            raise ValueError("host_frac must be in [0, 1]")
        if self.pcie_gbps <= 0.0:
            raise ValueError("pcie_gbps must be positive")

    def roundtrip_cycles(self, clock_ghz: float = CHIP_CLOCK_GHZ) -> float:
        """Cycles to fault one page in (and one victim out) over PCIe."""
        xfer_s = 2 * self.page_kb * 1024 / (self.pcie_gbps * 1e9)
        return (self.pcie_latency_us * 1e-6 + xfer_s) * clock_ghz * 1e9

    def page_in_cycles(self, clock_ghz: float = CHIP_CLOCK_GHZ) -> float:
        """Cycles to move one page host->device (one direction, no victim
        write-back): the per-page price of a planned swap-in."""
        xfer_s = self.page_kb * 1024 / (self.pcie_gbps * 1e9)
        return (self.pcie_latency_us * 1e-6 + xfer_s) * clock_ghz * 1e9


@dataclasses.dataclass(frozen=True)
class SpillTierConfig:
    """The third tier: a file/bytes-backed spill store one hop below host
    DRAM.  A page parked here is two hops from the device: a restore pays
    the spill read (this config) plus the host->device PCIe transfer
    (:class:`HostTierConfig`).  ``spill_frac`` is the fraction of host-tier
    faults whose page was demoted on down to the spill store."""
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

    def page_in_cycles(self, clock_ghz: float = CHIP_CLOCK_GHZ) -> float:
        """Cycles to promote one page SPILL -> HOST."""
        xfer_s = self.page_kb * 1024 / (self.read_gbps * 1e9)
        return (self.latency_us * 1e-6 + xfer_s) * clock_ghz * 1e9

    def page_out_cycles(self, clock_ghz: float = CHIP_CLOCK_GHZ) -> float:
        """Cycles to demote one page HOST -> SPILL."""
        xfer_s = self.page_kb * 1024 / (self.write_gbps * 1e9)
        return (self.latency_us * 1e-6 + xfer_s) * clock_ghz * 1e9

    def roundtrip_cycles(self, clock_ghz: float = CHIP_CLOCK_GHZ) -> float:
        """Cycles to fault one page up from spill AND demote a victim down."""
        return self.page_in_cycles(clock_ghz) + self.page_out_cycles(clock_ghz)


#: default price of re-prefilling one token through the serving model.  A
#: stand-in FLOPs proxy: only its RATIO to the PCIe page cost matters for
#: ranking admissions.
PREFILL_CYCLES_PER_TOKEN = 10_000.0


def admission_score(shared_tokens: int, swap_in_pages: int, page_slots: int,
                    host: HostTierConfig | None = None,
                    prefill_cycles_per_token: float = PREFILL_CYCLES_PER_TOKEN,
                    clock_ghz: float = CHIP_CLOCK_GHZ,
                    spill_in_pages: int = 0,
                    spill: SpillTierConfig | None = None) -> float:
    """Price an admission's residency terms into one score (cycles saved).

    ``shared_tokens`` resident prompt tokens skip their prefill outright; a
    swap record skips re-prefilling its ``swap_in_pages * page_slots``
    committed tokens but pays each page's PCIe transfer, and the
    ``spill_in_pages`` among them pay the extra SPILL -> HOST hop.  A cold
    request scores 0.  The score is a ranking signal, not a latency."""
    host = host if host is not None else HostTierConfig()
    saved = shared_tokens * prefill_cycles_per_token
    if swap_in_pages:
        saved += swap_in_pages * page_slots * prefill_cycles_per_token
        saved -= swap_in_pages * host.page_in_cycles(clock_ghz)
    if spill_in_pages:
        spill = spill if spill is not None else SpillTierConfig()
        saved -= spill_in_pages * spill.page_in_cycles(clock_ghz)
    return saved
