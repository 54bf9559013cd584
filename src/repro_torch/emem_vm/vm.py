"""EMemVM: virtual reads/writes over the emulated memory (a port of
``repro.emem_vm.vm``).

``vread``/``vwrite`` take *logical* slot addresses, translate them through
the page table (:mod:`repro_torch.emem_vm.page_table`), consult the
per-requester hot-page cache (:mod:`repro_torch.emem_vm.cache`), and fall
through to the emulated memory (:mod:`repro_torch.core.emem`) on miss --
``read_ref``/``write_ref`` on one unsharded store, or, with
``sharded=True``, the emulated-shard ``read``/``write`` (the reference's
mesh collectives, one K7 launch per read).

Semantics (mirroring EMem's drop rules):
  * reads of unmapped / non-readable pages return zeros;
  * writes to unmapped / non-writable pages are dropped (physically they are
    redirected to a reserved *trash frame* -- the last physical frame, which
    the allocator never hands out -- so every batch keeps a static shape);
  * accesses to *swapped-out* pages (mapped, contents on host -- the page
    table's swapped bit) FAULT: the control-plane half of ``vread``/
    ``vwrite`` swaps the page back into a device frame first, evicting the
    least-recently-used resident page if the pool is full, then runs the
    data-plane step.  ``swap_out``/``swap_in`` are also available directly
    so a residency policy can pre-evict cold pages;
  * the cache is write-back: a write hit lands only in the cache and the
    line is flushed to the emulated memory on eviction, ``flush()``, or when
    its frame is freed.  Reads are therefore always served from the cache on
    hit (the cached line may be newer than the memory).

Whole pages -- the cache fill and the swap-out -- are read with one K6
launch on the frames' rows where the reference's slot read cannot drop a
request (an unsharded store, or ``cap_factor >= n_shards``, the default);
otherwise they take the reference's slot route.  The bits are the same.

The access path lives in the functions :func:`read_step` /
:func:`write_step` (state in, state out; the store and the cache are
updated in place); :class:`EMemVM` is the thin stateful facade.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import emem
from repro_torch.device import resolve_device
from repro_torch.emem_vm import page_table as pt_mod
from repro_torch.emem_vm.allocator import FrameAllocator, OutOfFrames
from repro_torch.emem_vm.cache import CacheSpec, HotPageCache
from repro_torch.emem_vm.layout import frame_rows
from repro_torch.emem_vm.spill import SpillStore
from repro_torch.kernels.paged_decode import gather_ops


@dataclasses.dataclass(frozen=True)
class VMConfig:
    """Static description of a virtual emulated memory."""
    spec: emem.EMemSpec             # physical memory (incl. the trash frame)
    n_vpages: int                   # logical pages addressable via the table
    cache_sets: int = 0             # 0 = hot-page cache disabled
    n_requesters: int = 1
    #: Sized so no request is ever dropped by the EMem capacity queues
    #: (capacity == requests-per-shard when factor >= n_shards).
    capacity_factor: float | None = None
    #: host backing-store capacity in pages (None = unbounded).  When
    #: bounded, a swap-out that finds the host store full demotes its LRU
    #: host page into the spill tier (HOST -> SPILL) instead of growing
    #: without limit; a fault on a spilled page promotes two-hop
    #: (SPILL -> HOST -> DEVICE).
    n_host_pages: int | None = None
    #: directory backing the spill store (None: in-memory bytes)
    spill_path: str | None = None

    def __post_init__(self):
        if self.spec.n_pages < 2:
            raise ValueError("need >= 2 physical frames (one is the trash "
                             "frame)")
        if self.n_host_pages is not None and self.n_host_pages < 0:
            raise ValueError("n_host_pages must be >= 0 (or None for an "
                             "unbounded host store)")

    @property
    def trash_frame(self) -> int:
        return self.spec.n_pages - 1

    @property
    def trash_addr(self) -> int:
        return self.trash_frame * self.spec.page_slots

    @property
    def cap_factor(self) -> float:
        return (self.capacity_factor if self.capacity_factor is not None
                else float(self.spec.n_shards))

    def cache_spec(self) -> CacheSpec | None:
        if self.cache_sets <= 0:
            return None
        return CacheSpec(n_requesters=self.n_requesters,
                         n_sets=self.cache_sets,
                         page_slots=self.spec.page_slots,
                         width=self.spec.width, dtype=self.spec.dtype)


# ---------------------------------------------------------------------------
# Backing-memory access (one unsharded store, or emulated shards)
# ---------------------------------------------------------------------------
def _pad_addrs(cfg: VMConfig, addrs: torch.Tensor,
               values: torch.Tensor | None):
    """Pad a batch to a multiple of n_shards with trash-frame accesses."""
    s = cfg.spec.n_shards
    n = addrs.shape[0]
    pad = (-n) % s
    if pad:
        addrs = torch.cat([addrs, addrs.new_full((pad,), cfg.trash_addr)])
        if values is not None:
            values = torch.cat([values,
                                values.new_zeros((pad, cfg.spec.width))])
    return addrs, values, n


def _mem_read(cfg: VMConfig, sharded: bool, data: torch.Tensor,
              addrs: torch.Tensor) -> torch.Tensor:
    if not sharded:
        return emem.read_ref(cfg.spec, data, addrs)
    addrs, _, n = _pad_addrs(cfg, addrs, None)
    return emem.read(cfg.spec, data, addrs, cfg.cap_factor)[:n]


def _mem_write(cfg: VMConfig, sharded: bool, data: torch.Tensor,
               addrs: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    if not sharded:
        return emem.write_ref(cfg.spec, data, addrs, values)
    addrs, values, _ = _pad_addrs(cfg, addrs, values)
    return emem.write(cfg.spec, data, addrs, values, cfg.cap_factor)


def _mem_read_pages(cfg: VMConfig, sharded: bool, data: torch.Tensor,
                    frames: torch.Tensor) -> torch.Tensor:
    """Whole frames [n] -> [n, page_slots, width]: one K6 launch on the
    frames' rows where the slot read of every lane cannot drop, else the
    reference's slot read."""
    spec = cfg.spec
    if not sharded or cfg.cap_factor >= spec.n_shards:
        rows = (frame_rows(frames, spec.n_pages, spec.n_shards) if sharded
                else frames)
        return gather_ops.gather_pages(data, rows)
    lane = torch.arange(spec.page_slots, device=frames.device)
    addrs = (frames[:, None] * spec.page_slots + lane).reshape(-1)
    return _mem_read(cfg, sharded, data, addrs).view(
        -1, spec.page_slots, spec.width)


# ---------------------------------------------------------------------------
# Access steps (state in, state out)
# ---------------------------------------------------------------------------
def read_step(cfg: VMConfig, sharded: bool, entries: torch.Tensor,
              data: torch.Tensor, cache: dict | None, addrs,
              requester: int = 0):
    """Virtual read.  Returns (out [R, width], data', cache')."""
    ps = cfg.spec.page_slots
    addrs = torch.as_tensor(addrs, device=data.device)
    frames, offsets, readable, _ = pt_mod.translate(entries, addrs, ps)
    phys = torch.where(readable, frames * ps + offsets, cfg.trash_addr)

    cspec = cfg.cache_spec()
    if cspec is None or cache is None:
        out = _mem_read(cfg, sharded, data, phys)
        return out.masked_fill(~readable[:, None], 0), data, cache

    cache_vals, hit = HotPageCache.lookup(cspec, cache, requester, frames,
                                          offsets)
    mem_vals = _mem_read(cfg, sharded, data, phys)
    out = torch.where((hit & readable)[:, None], cache_vals, mem_vals)
    out = out.masked_fill(~readable[:, None], 0)
    cache = HotPageCache.count(cspec, cache, requester, hit, readable)

    # fill: one candidate per set (last miss wins), evicting dirty victims
    miss = readable & ~hit
    chosen = HotPageCache.plan_fill(cspec, frames, miss)
    victim_tag, needs_wb, victim_pages = HotPageCache.victims(
        cspec, cache, requester, chosen)
    lane = torch.arange(ps, device=data.device)
    wb_addrs = (torch.where(needs_wb, victim_tag.long(), cfg.trash_frame)
                [:, None] * ps + lane).reshape(-1)
    data = _mem_write(cfg, sharded, data, wb_addrs,
                      victim_pages.reshape(-1, cfg.spec.width))
    pages = _mem_read_pages(cfg, sharded, data,
                            torch.where(chosen >= 0, chosen, cfg.trash_frame))
    cache = HotPageCache.apply_fill(cspec, cache, requester, chosen, pages)
    return out, data, cache


def write_step(cfg: VMConfig, sharded: bool, entries: torch.Tensor,
               data: torch.Tensor, cache: dict | None, addrs, values,
               requester: int = 0):
    """Virtual write.  Returns (data', cache')."""
    ps = cfg.spec.page_slots
    addrs = torch.as_tensor(addrs, device=data.device)
    values = torch.as_tensor(values, device=data.device)
    frames, offsets, _, writable = pt_mod.translate(entries, addrs, ps)
    phys = frames * ps + offsets

    cspec = cfg.cache_spec()
    if cspec is None or cache is None:
        safe = torch.where(writable, phys, cfg.trash_addr)
        return _mem_write(cfg, sharded, data, safe, values), cache

    _, hit = HotPageCache.lookup(cspec, cache, requester, frames, offsets)
    cache = HotPageCache.write_hits(cspec, cache, requester, frames, offsets,
                                    values, hit & writable)
    cache = HotPageCache.count(cspec, cache, requester, hit, writable)
    # no-write-allocate: misses go straight to the emulated memory
    safe = torch.where(writable & ~hit, phys, cfg.trash_addr)
    data = _mem_write(cfg, sharded, data, safe, values)
    return data, cache


# ---------------------------------------------------------------------------
# Facade
# ---------------------------------------------------------------------------
class EMemVM:
    """Stateful virtual-memory facade over one emulated memory on ``device``
    (``cuda`` unless the caller names another).  ``sharded=True`` spreads
    the store over ``cfg.spec.n_shards`` emulated shards (physical page
    order, :func:`repro_torch.core.emem.to_logical` gives the logical one),
    as the reference's ``mesh=`` does over devices."""

    def __init__(self, cfg: VMConfig, sharded: bool = False, device=None):
        self.cfg = cfg
        self.sharded = sharded
        self.device = resolve_device(device)
        spec = cfg.spec
        self.data = emem.create(spec, self.device)
        # usable frames exclude the trash frame (spec.n_pages - 1)
        self.allocator = FrameAllocator(spec.n_pages - 1)
        self.page_table = pt_mod.PageTable(cfg.n_vpages, spec.page_slots,
                                           device=self.device)
        cspec = cfg.cache_spec()
        self.cache = HotPageCache.create(cspec, self.device) if cspec else None
        #: host backing store for swapped-out pages: vpage -> [ps, width] CPU
        #: tensor (insertion order == swap-out order, the host tier's
        #: demotion LRU)
        self._host_pages: dict[int, torch.Tensor] = {}
        #: third tier: serialized bytes the bounded host store demotes into
        #: (None with an unbounded host store)
        self._spill = (SpillStore(cfg.spill_path)
                       if cfg.n_host_pages is not None else None)
        #: LRU bookkeeping for fault-time victim selection
        self._use_tick: dict[int, int] = {}
        self._tick = 0
        self.swap_counters = {"swap_outs": 0, "swap_ins": 0, "faults": 0,
                              "spill_outs": 0, "spill_ins": 0}

    def _frame_slots(self, frame: int) -> torch.Tensor:
        ps = self.cfg.spec.page_slots
        return frame * ps + torch.arange(ps, device=self.device)

    # -- mapping (control plane) ---------------------------------------------
    def map_page(self, vpage: int, prot: int = pt_mod.PROT_RW) -> int:
        frame = self.allocator.alloc()
        self.page_table.map(vpage, frame, prot)
        return frame

    def map_range(self, vpage_start: int, n: int,
                  prot: int = pt_mod.PROT_RW) -> list[int]:
        return [self.map_page(vpage_start + i, prot) for i in range(n)]

    def unmap_page(self, vpage: int) -> None:
        if self.page_table.is_swapped(vpage):
            self.page_table.unmap(vpage)          # no device frame to free
            self._host_pages.pop(vpage, None)
            if self._spill is not None:
                self._spill.drop(vpage)
            self._use_tick.pop(vpage, None)
            return
        frame = self.page_table.frame_of(vpage)
        self._writeback_frame(frame)
        if self.cache is not None:
            self.cache = HotPageCache.invalidate_frame(
                self.cfg.cache_spec(), self.cache, frame)
        self.page_table.unmap(vpage)
        self.allocator.free(frame)
        self._use_tick.pop(vpage, None)

    def protect(self, vpage: int, prot: int) -> None:
        self.page_table.protect(vpage, prot)

    # -- residency (DEVICE <-> HOST <-> SPILL swap) ----------------------------
    def _demote_host_lru(self) -> None:
        """HOST -> SPILL: serialize the oldest-swapped-out host page into
        the spill store, keeping the bounded host store within capacity."""
        vp, page = next(iter(self._host_pages.items()))
        self._spill.put(vp, page)
        del self._host_pages[vp]
        self.swap_counters["spill_outs"] += 1

    def swap_out(self, vpage: int) -> None:
        """Evict a device-resident page to the host store (DEVICE -> HOST).

        The dirty cache line (if any) is written back first, then the page
        is read out of the emulated memory (one K6 launch) into a host copy
        and the device frame returns to the free list.  With a bounded host
        store (``cfg.n_host_pages``) the eviction that overflows it demotes
        the LRU host page on down into the spill tier.  The page stays
        mapped but invalid -- a later access faults it back in."""
        frame = self.page_table.frame_of(vpage)    # raises if not resident
        self._writeback_frame(frame)
        if self.cache is not None:
            self.cache = HotPageCache.invalidate_frame(
                self.cfg.cache_spec(), self.cache, frame)
        page = _mem_read_pages(self.cfg, self.sharded, self.data,
                               torch.tensor([frame], device=self.device))[0]
        self._host_pages[vpage] = page.cpu()
        if self._spill is not None:
            while len(self._host_pages) > self.cfg.n_host_pages:
                self._demote_host_lru()
        self.page_table.mark_swapped(vpage)
        self.allocator.free(frame)
        self._use_tick.pop(vpage, None)
        self.swap_counters["swap_outs"] += 1

    def swap_in(self, vpage: int) -> int:
        """Fault a swapped-out page back into a device frame; returns the
        frame.  A host-resident page is the one-hop HOST -> DEVICE path; a
        spilled page promotes two-hop (SPILL -> HOST -> DEVICE).  Raises
        :class:`OutOfFrames` when the pool is full -- callers that can
        tolerate eviction should go through the ``vread``/``vwrite`` fault
        path, which picks an LRU victim."""
        if not self.page_table.is_swapped(vpage):
            raise ValueError(f"vpage {vpage} not swapped out")
        frame = self.allocator.alloc()     # before any payload I/O: an
        # OutOfFrames retry (after LRU victim eviction) must not have paid
        # a wasted spill read, and the backing tiers stay untouched
        if vpage in self._host_pages:
            page, from_spill = self._host_pages[vpage], False
        else:                              # SPILL -> HOST first leg
            page, from_spill = self._spill.get(vpage), True
        self.data = _mem_write(self.cfg, self.sharded, self.data,
                               self._frame_slots(frame),
                               page.to(self.device))
        self.page_table.restore(vpage, frame)
        if from_spill:
            self._spill.drop(vpage)
            self.swap_counters["spill_ins"] += 1
        else:
            del self._host_pages[vpage]
        self.swap_counters["swap_ins"] += 1
        return frame

    def _fault_in(self, addrs) -> None:
        """Control-plane fault handler: make every swapped page addressed by
        this batch device-resident before the data-plane step runs.  Evicts
        least-recently-used resident pages when the pool is exhausted.

        Free when nothing is swapped out: the swap-free data path must not
        pay host-side per-access bookkeeping (nor a copy of the addresses
        to the host)."""
        if not self._host_pages and \
                (self._spill is None or len(self._spill) == 0):
            return
        ps = self.cfg.spec.page_slots
        if isinstance(addrs, torch.Tensor):
            addrs = addrs.cpu().numpy()
        vpages = np.unique(np.asarray(addrs, np.int64) // ps)
        vpages = vpages[(vpages >= 0) & (vpages < self.page_table.n_vpages)]
        needed = set(int(v) for v in vpages)
        self._tick += 1
        for vp in needed:
            if self.page_table.is_mapped(vp):
                self._use_tick[vp] = self._tick
        faulted = [vp for vp in needed if self.page_table.is_swapped(vp)]
        for vp in faulted:
            while True:
                try:
                    self.swap_in(vp)
                    break
                except OutOfFrames:
                    victim = self._lru_victim(exclude=needed)
                    if victim is None:
                        raise
                    self.swap_out(victim)
            self._use_tick[vp] = self._tick
            self.swap_counters["faults"] += 1

    def _lru_victim(self, exclude) -> int | None:
        """Least-recently-used device-resident page outside ``exclude``."""
        victim, best = None, None
        for vp in range(self.page_table.n_vpages):
            if vp in exclude or not self.page_table.is_mapped(vp):
                continue
            tick = self._use_tick.get(vp, 0)
            if best is None or tick < best:
                victim, best = vp, tick
        return victim

    # -- data plane -----------------------------------------------------------
    def vread(self, addrs, requester: int = 0) -> torch.Tensor:
        self._fault_in(addrs)
        out, self.data, self.cache = read_step(
            self.cfg, self.sharded, self.page_table.entries, self.data,
            self.cache, addrs, requester)
        return out

    def vwrite(self, addrs, values, requester: int = 0) -> None:
        self._fault_in(addrs)
        self.data, self.cache = write_step(
            self.cfg, self.sharded, self.page_table.entries, self.data,
            self.cache, addrs, values, requester)

    # -- cache maintenance ----------------------------------------------------
    def _writeback_frame(self, frame: int) -> None:
        """Flush any requester's dirty line holding ``frame`` to memory."""
        if self.cache is None:
            return
        cspec = self.cfg.cache_spec()
        sets = frame % cspec.n_sets
        tags = self.cache["tag"][:, sets].tolist()
        dirty = self.cache["dirty"][:, sets].tolist()
        for req in range(cspec.n_requesters):
            if tags[req] == frame and dirty[req]:
                self.data = _mem_write(self.cfg, self.sharded, self.data,
                                       self._frame_slots(frame),
                                       self.cache["data"][req, sets])

    def flush(self) -> None:
        """Write back every dirty line and mark the whole cache clean."""
        if self.cache is None:
            return
        cspec = self.cfg.cache_spec()
        ps = self.cfg.spec.page_slots
        lane = torch.arange(ps, device=self.device)
        for req in range(cspec.n_requesters):
            tags, dirty, pages = HotPageCache.dirty_lines(cspec, self.cache,
                                                          req)
            addrs = (torch.where(dirty, tags.long(), self.cfg.trash_frame)
                     [:, None] * ps + lane).reshape(-1)
            self.data = _mem_write(self.cfg, self.sharded, self.data, addrs,
                                   pages.reshape(-1, self.cfg.spec.width))
            self.cache = HotPageCache.mark_clean(cspec, self.cache, req)

    # -- introspection --------------------------------------------------------
    def counters(self) -> dict:
        if self.cache is None:
            return {"hits": 0, "misses": 0, "hit_rate": 0.0,
                    **self.swap_counters}
        hits = int(self.cache["hits"].sum())
        misses = int(self.cache["misses"].sum())
        return {"hits": hits, "misses": misses,
                "hit_rate": hits / max(hits + misses, 1),
                **self.swap_counters}

    def stats(self) -> dict:
        return {**self.allocator.stats(), **self.counters(),
                "mapped_pages": self.page_table.mapped_count(),
                "swapped_pages": self.page_table.swapped_count(),
                "host_pages": len(self._host_pages),
                "spilled_pages": (len(self._spill)
                                  if self._spill is not None else 0)}
