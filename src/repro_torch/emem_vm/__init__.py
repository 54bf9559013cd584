"""EMemVM -- a virtual-memory subsystem over the emulated memory (a port of
``repro.emem_vm``).

:mod:`repro_torch.core.emem` is the paper's emulation with static
addressing; this package adds the indirection that turns it into a memory
system:

  * :mod:`~repro_torch.emem_vm.page_table` -- batched logical->physical
    translation (valid, R/W and swapped bits), laid out as a small EMem;
  * :mod:`~repro_torch.emem_vm.allocator` -- the refcounted frame allocator
    over the physical page pool, with host and spill tiers;
  * :mod:`~repro_torch.emem_vm.cache` -- a fixed-capacity per-requester
    hot-page cache (direct-mapped, write-back with dirty bits);
  * :mod:`~repro_torch.emem_vm.vm` -- the :class:`EMemVM` facade exposing
    ``vread``/``vwrite`` that translate through the page table, consult the
    cache, and fall through to the emulated memory on miss, with swap/spill
    residency;
  * :mod:`~repro_torch.emem_vm.block_manager` -- refcounted block tables
    for the serving engine: prefix sharing, copy-on-write, reserved vs
    on-demand allocation, tiered residency and fused-run staging (pure
    numpy);
  * :mod:`~repro_torch.emem_vm.prefix_tree` -- the radix index over prompt
    token ids behind prefix sharing and retention;
  * :mod:`~repro_torch.emem_vm.spill` -- the :class:`SpillStore`, the third
    tier the host store demotes into.
"""
from repro_torch.emem_vm.allocator import (FrameAllocator, OutOfFrames,  # noqa: F401
                                           OutOfHostFrames, OutOfSpillFrames,
                                           RES_DEVICE, RES_FREE, RES_HOST,
                                           RES_SPILL)
from repro_torch.emem_vm.block_manager import (AdmissionCost, BlockManager,  # noqa: F401
                                               CowCopy, PageIO)
from repro_torch.emem_vm.layout import frame_rows, shard_frames  # noqa: F401
from repro_torch.emem_vm.prefix_tree import PrefixTree  # noqa: F401
from repro_torch.emem_vm.spill import SpillStore  # noqa: F401
from repro_torch.emem_vm.cache import CacheSpec, HotPageCache  # noqa: F401
from repro_torch.emem_vm.page_table import PROT_NONE, PROT_R, PROT_RW, PROT_W  # noqa: F401
from repro_torch.emem_vm.page_table import PageTable  # noqa: F401
from repro_torch.emem_vm.vm import EMemVM, VMConfig  # noqa: F401
