"""Core: the paper's contribution.

Executable layer (the emulation scheme on one device):
  emem      -- a flat address space over cyclically owned emulated shards
Analytic layer (the slice the scheduler prices admissions with):
  emulation -- the host and spill tiers' costs and ``admission_score``

The reference's other analytic models (``params``, ``topology``, ``vlsi``,
``latency``, ``dram`` and the rest of ``emulation``) are not ported yet.
"""
from repro_torch.core import emem, emulation  # noqa: F401
