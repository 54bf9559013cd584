"""Sequential-machine DRAM baseline (paper §6.1).

The paper measures the average random-access latency of a DDR3 system with
DRAMSim2 [38] using a closed-loop, one-transaction-at-a-time random workload:
35 ns for a single-rank 1 GB system, 36 ns for 2-16 GB multi-rank systems.

DRAMSim2 is not available offline, so we reproduce the measurement with an
analytic DDR3 timing model of the same device class (Micron MT41J128M8,
DDR3-1600 [34]).  With one transaction in flight and auto-precharge, every
access finds its bank precharged, so the access time is

    t_access = t_cmd + t_RCD + t_CL + t_burst/2

(the average read returns its critical word half-way through the burst).
Rank-to-rank switching adds ~1 cycle for multi-rank systems.

A copy of ``repro.core.dram``: every constant and float is the
reference's.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DDR3Timing:
    """DDR3-1600 (Micron MT41J128M8JP-125) timing parameters."""
    tck_ns: float = 1.25          # I/O clock period (800 MHz, DDR-1600)
    cl_cycles: int = 11           # CAS latency
    trcd_cycles: int = 11         # row-to-column delay
    trp_cycles: int = 11          # row precharge
    trc_ns: float = 48.75         # row cycle time
    burst_len: int = 8            # BL8
    cmd_cycles: int = 4           # command/address transport + controller

    @property
    def trcd_ns(self) -> float:
        return self.trcd_cycles * self.tck_ns

    @property
    def tcl_ns(self) -> float:
        return self.cl_cycles * self.tck_ns

    @property
    def burst_ns(self) -> float:
        # DDR: burst_len beats at two beats per clock
        return self.burst_len / 2.0 * self.tck_ns


@dataclasses.dataclass(frozen=True)
class DRAMSystem:
    capacity_gb: int = 1
    rank_gb: int = 1
    timing: DDR3Timing = DDR3Timing()

    @property
    def n_ranks(self) -> int:
        return max(1, self.capacity_gb // self.rank_gb)

    def random_access_latency_ns(self) -> float:
        t = self.timing
        lat = (t.cmd_cycles * t.tck_ns + t.trcd_ns + t.tcl_ns + t.burst_ns / 2.0)
        if self.n_ranks > 1:
            lat += t.tck_ns  # rank-switch bubble (paper: +1 ns for 2-16 GB)
        return lat

    def random_access_latency_cycles(self, clock_ghz: float = 1.0) -> float:
        return self.random_access_latency_ns() * clock_ghz


def paper_baseline(capacity_gb: int = 1) -> float:
    """Average random-access latency (ns) for the paper's baseline machine."""
    return DRAMSystem(capacity_gb=capacity_gb).random_access_latency_ns()
