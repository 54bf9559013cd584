"""Core: the paper's contribution.

Executable layer (the emulation scheme on one device or a process group):
  emem      -- a flat address space over cyclically owned emulated shards
Analytic layer (paper §4-7, host arithmetic, copies of ``repro.core``'s):
  params    -- implementation-technology parameters (Tables 1-5)
  dram      -- the DDR3 baseline (§6.1)
  topology  -- folded Clos and 2D mesh networks
  vlsi      -- chip and interposer area / floorplan (Figs. 5-7)
  latency   -- message latency and emulated access latency (Fig. 9)
  emulation -- slowdown of a sequential program (Figs. 10-13, §7.3) and the
               host and spill tiers' ``admission_score``
"""
from repro_torch.core import (  # noqa: F401
    dram, emem, emulation, latency, params, topology, vlsi)
