"""The BlockManager half of the emulated-memory VM: refcounted block tables,
prefix sharing, residency tiers (host, spill) and fused-run staging.  Pure
numpy; the page table, hot-page cache and ``EMemVM`` of the reference wait
for a later slice (ROADMAP Queue 1)."""
from repro_torch.emem_vm.allocator import (FrameAllocator, OutOfFrames,  # noqa: F401
                                           OutOfHostFrames, OutOfSpillFrames,
                                           RES_DEVICE, RES_FREE, RES_HOST,
                                           RES_SPILL)
from repro_torch.emem_vm.block_manager import (AdmissionCost, BlockManager,  # noqa: F401
                                               CowCopy, PageIO)
from repro_torch.emem_vm.layout import frame_rows, shard_frames  # noqa: F401
from repro_torch.emem_vm.prefix_tree import PrefixTree  # noqa: F401
from repro_torch.emem_vm.spill import SpillStore  # noqa: F401
