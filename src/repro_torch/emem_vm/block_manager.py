"""BlockManager: refcounted ownership + tiered residency of KV frames.

The third layer of the memory stack.  :mod:`repro_torch.core.emem` is the
*physical* emulation (address -> owner is arithmetic), :mod:`repro_torch.emem_vm`
adds *virtual* addressing (page table + allocator + hot-page cache), and
this module owns the *sequence* level: which logical page of which sequence
lives in which physical frame, who else is allowed to read it, and -- since
the residency refactor -- which tier it currently occupies.

Every serving sequence -- whatever the engine's ``kv_layout`` -- goes
through one logical->frame block table here.  The two layouts are just
allocation policies:

  * ``policy="reserved"`` (``kv_layout="paged"``): every sequence slot
    permanently owns ``max_lpages`` frames, assigned once at construction.
    Admission never allocates, completion never frees; the table is static
    and reproduces the fixed slots x max_pages layout exactly.
  * ``policy="on_demand"`` (``kv_layout="pooled"``): frames come from the
    shared pool as a sequence grows and return when it completes, with
    prefix sharing (admission matches new prompts against live prompts and
    the retention pool; covered pages are shared refcount++ instead of
    recomputed) and copy-on-write (`CowCopy` records tell the engine which
    device pages to copy on the first divergent write).

**Residency state machine** (``FREE -> DEVICE -> HOST -> SPILL -> FREE``),
on-demand policy only:

  * :meth:`evict_seq` moves every frame a sequence holds to the host
    backing store -- the engine's page-IO callback reads the device pages,
    the payloads are parked in host frames (a separate id space in the
    :class:`FrameAllocator`), and the device frames return to the pool.
    Shared prefix frames are snapshotted too (the copy is taken *before*
    the deref, so eviction is safe whether or not other owners remain).
  * :meth:`restore_seq` is the inverse: fresh device frames are allocated,
    the parked payloads written back through the page-IO callback, and the
    block table rebuilt.  Preemption + restore therefore trades prefill
    FLOPs for PCIe bytes -- resume is a swap-in, not a recompute.
  * the **host tier is an actively managed cache**, not a fixed pool: when
    an eviction finds the host store full, :meth:`_demote_host` moves host
    pages one tier further down into the :class:`SpillStore`
    (file/``bytes``-backed) instead of failing the eviction into the
    recompute cliff.  Demotion priority: snapshots of shared/retained
    *prefix* pages first (their device copy usually still serves the
    retention pool, so they are the coldest bytes on host), then the
    oldest preempted sequences' pages, LRU by preemption order.  A restore
    of a spilled page is a *two-hop* promotion (``SPILL -> HOST ->
    DEVICE``): the payload is deserialized into host memory and written on
    to a device frame, and :class:`AdmissionCost.spill_in_pages` reports
    the extra hop so the scheduler prices it honestly.  Only when BOTH
    backing tiers are full does :meth:`evict_seq` return None (the
    caller's recompute fallback).
  * the **retention pool** keeps completed prompts' prefix pages alive in a
    bounded LRU (:attr:`retain_frames` device frames max) so a system
    prompt survives idle gaps between requests.  Retained frames hold a
    refcount but no *pin*, which makes them the allocator's eviction
    candidates: pool pressure reclaims them LRU-first before any live
    sequence is preempted.

Shared frames are read-only to every owner: ``frame_ro()`` exports the
refcount>1 bit, which rides in ``cache["vm"]`` into the paged-attention
kernel where writes to shared frames are dropped (defense in depth -- the
engine resolves COW host-side *before* the decode step that writes).

**Prefix index** (``prefix_index="tree"``, the default): prompt matching
and the retention pool live in a :class:`~repro_torch.emem_vm.prefix_tree.
PrefixTree` -- a compressed radix tree over token ids whose pool
terminals own the retained page lists and whose live terminals mirror
the live prompts.  ``_match_prefix`` is one O(prompt-length) descent
regardless of pool size, LRU reclaim prunes the coldest pool terminal,
and ``_reclaimable`` reads tree-maintained per-frame counts instead of
walking every entry.  ``prefix_index="linear"`` keeps the retired
scan-everything matcher (``_retained`` OrderedDict) for a while as the
differential-test oracle; both produce byte-identical donors, allocator
traffic and reclaim order.  ``epoch`` is a monotone counter bumped on
every mutation that can change an admission cost -- unlike ``dirty``
(which the engine clears after re-pushing tables) it never goes
backwards, so the scheduler keys its admission-score cache on it.

All state is host-side numpy (control plane); the data plane only ever sees
the exported tables.  The page payloads moved by evict/restore are opaque to
this module -- the engine's :class:`PageIO` callbacks read and write the
actual device pages, so the BlockManager never learns the model's cache
layout.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Sequence

import numpy as np

from repro_torch.emem_vm.allocator import (FrameAllocator, OutOfFrames,  # noqa: F401
                                     OutOfHostFrames, OutOfSpillFrames)
from repro_torch.emem_vm.prefix_tree import PrefixTree
from repro_torch.emem_vm.spill import SpillStore


@dataclasses.dataclass(frozen=True)
class AdmissionCost:
    """What admitting a request *right now* would cost and save -- the
    residency signal the scheduler's admission policy prices into a score
    (``emulation.admission_score``).

    Under the reserved policy every field is zero (static tables carry no
    residency information), so any score built on top degenerates to FIFO.
    """
    #: device frames the admission must allocate (prefill pages after
    #: prefix sharing, or the swap record's page count for a resume)
    new_frames: int
    #: leading prompt tokens whose prefill would be skipped because their
    #: pages are resident (retention pool or a live sequence's prefix)
    shared_tokens: int
    #: backing-store pages a swap-resume would move back over PCIe (0 for a
    #: fresh admission; counts every parked page, whichever tier holds it)
    swap_in_pages: int
    #: a swap record is parked on the backing tiers for this request
    has_swap: bool
    #: the need is coverable right now (free frames + drainable retention)
    admissible: bool
    #: of ``swap_in_pages``, how many sit in the spill tier and pay the
    #: extra SPILL -> HOST hop on top of the PCIe transfer (two-hop restore)
    spill_in_pages: int = 0


@dataclasses.dataclass(frozen=True)
class CowCopy:
    """Device-side page copy the engine must apply: frame ``src`` -> ``dst``
    (every attention layer's k_pages/v_pages row)."""
    src: int
    dst: int


@dataclasses.dataclass(frozen=True)
class StagedPrefetch:
    """A prefetch frame pre-staged for a fused multi-step decode run.

    The allocator side effects (alloc + pin) happen at staging time so the
    headroom gate sees exactly the state it would have seen stepwise; the
    table mapping and counters are deferred to :meth:`BlockManager.
    commit_fused_run`, which replays them against the number of steps the
    device loop actually executed."""
    seq: int
    lpage: int
    frame: int
    #: 0-based fused step whose post-step prefetch hook staged this frame
    k_alloc: int

    @property
    def k_hit(self) -> int:
        """Step whose boundary write first lands in the staged page."""
        return self.k_alloc + 1


@dataclasses.dataclass(frozen=True)
class PendingHit:
    """A pre-run prefetched page whose hit accounting settles at fused step
    ``k_hit`` (the first write into it during the run)."""
    seq: int
    lpage: int
    k_hit: int


@dataclasses.dataclass
class FusedRunPlan:
    """Host-side plan for one fused decode run: ``n`` steps are guaranteed
    free of *unplanned* host-side frame management, ``allocs`` are the
    prefetches staged inside the run (frames already allocated + pinned),
    ``hits`` the pre-run prefetched pages whose first write falls inside
    it.  Settle with :meth:`BlockManager.commit_fused_run` (passing the
    step count the device loop really executed) or :meth:`BlockManager.
    cancel_fused_run`."""
    n: int
    allocs: list[StagedPrefetch]
    hits: list[PendingHit]


@dataclasses.dataclass
class PageIO:
    """Engine-provided callbacks that move page contents across the tiers.

    ``read(frames)`` returns one opaque payload per device frame (the
    engine snapshots every attention layer's k/v page rows as numpy);
    ``write(assignments)`` applies ``[(frame, payload), ...]`` back onto the
    device pages.  The BlockManager decides *when* pages move; the engine
    decides *what* a page physically is."""
    read: Callable[[Sequence[int]], list]
    write: Callable[[Sequence[tuple]], None]


@dataclasses.dataclass
class _SwapRecord:
    """A preempted sequence's pages parked on the backing tiers, keyed by
    engine tag.  (Resume length and the pending token live in the engine's
    per-request resume record -- this side only owns the page payloads.)
    Insertion order of ``BlockManager._swapped`` is preemption order, which
    the host-pressure demotion policy reads as its LRU."""
    pages: list          # [(lpage, backing_frame), ...] in lpage order
    #: leading pages that were snapshots of a shared/retained prefix at
    #: eviction time -- the demotion policy's first-choice candidates
    prefix_pages: int = 0


@dataclasses.dataclass
class _RetainEntry:
    """A completed prompt's prefix pages kept alive for future admissions
    (``prefix_index="linear"`` oracle only -- the tree index stores these
    as pool terminals)."""
    tokens: np.ndarray   # the prompt whose KV the pages hold
    pages: list          # [(lpage, device_frame), ...]


class BlockManager:
    def __init__(self, n_frames: int, n_seqs: int, max_lpages: int,
                 page_slots: int, policy: str = "on_demand",
                 share_prefixes: bool = False, n_host_frames: int | None = None,
                 retain_frames: int = 0, swap_enabled: bool = True,
                 n_spill_frames: int = 0, spill_path: str | None = None,
                 prefix_index: str = "tree"):
        if policy not in ("reserved", "on_demand"):
            raise ValueError(f"unknown policy {policy!r}")
        if prefix_index not in ("tree", "linear"):
            raise ValueError(f"unknown prefix_index {prefix_index!r}")
        if policy == "reserved" and n_frames < n_seqs * max_lpages:
            raise ValueError(
                f"reserved policy needs {n_seqs * max_lpages} frames, "
                f"pool has {n_frames}")
        self.n_frames = n_frames
        self.n_seqs = n_seqs
        self.max_lpages = max_lpages
        self.page_slots = page_slots
        self.policy = policy
        #: monotone mutation counter over everything an admission cost can
        #: depend on (tables, refcounts, retention pool, swap records,
        #: sharing toggle).  Unlike ``dirty`` it is never cleared, so the
        #: scheduler's score cache keys on it.
        self.epoch = 0
        self.prefix_index = prefix_index if policy == "on_demand" else "linear"
        #: the radix-tree prefix index (matching + retention pool); None
        #: on the linear oracle path and under the reserved policy (which
        #: never matches or retains)
        self._tree = PrefixTree(page_slots) \
            if self.prefix_index == "tree" else None
        self.share_prefixes = share_prefixes and policy == "on_demand"
        #: host tier sizing: default one host frame per device frame
        if n_host_frames is None:
            n_host_frames = n_frames if policy == "on_demand" else 0
        self.swap_enabled = swap_enabled and policy == "on_demand"
        #: retention rides on the prefix-matching machinery, so it only
        #: engages while ``share_prefixes`` is on (checked at use time, not
        #: latched -- callers may toggle sharing after construction)
        self.retain_frames = retain_frames if policy == "on_demand" else 0
        #: spill tier: only meaningful where swapping is (on-demand policy);
        #: n_spill_frames=0 disables it and the two-tier behavior is
        #: byte-for-byte unchanged (host-full falls back to recompute)
        if policy != "on_demand":
            n_spill_frames = 0
        self.n_spill_frames = n_spill_frames
        self.spill = SpillStore(spill_path) if n_spill_frames > 0 else None
        self.allocator = FrameAllocator(n_frames, n_host_frames,
                                        n_spill_frames)
        self.block_table = np.full((n_seqs, max_lpages), -1, np.int32)
        self.frame_lpage = np.zeros(n_frames, np.int32)
        #: positions < shared_len[seq] are backed by valid shared prefix KV
        #: (writes there are idempotent re-runs and may be dropped)
        self.shared_len = np.zeros(n_seqs, np.int64)
        self._prompts: dict[int, np.ndarray] = {}   # live seq -> prompt toks
        #: engine-tag -> host-parked pages of a preempted sequence
        self._swapped: dict[int, _SwapRecord] = {}
        #: opaque host payloads, one per allocated host frame
        self._host_payloads: dict[int, object] = {}
        #: bounded LRU of completed prompts' prefix pages (key -> entry)
        self._retained: collections.OrderedDict[int, _RetainEntry] = \
            collections.OrderedDict()
        self._retain_key = 0
        #: set by the engine; None disables evict/restore (recompute path)
        self.page_io: PageIO | None = None
        #: (seq, lpage) pairs allocated ahead of the boundary token
        self._prefetched: set[tuple[int, int]] = set()
        self.counters = {"cow_copies": 0, "shared_frames": 0,
                         "shared_tokens": 0, "allocs": 0, "frees": 0,
                         "swap_out_pages": 0, "swap_in_pages": 0,
                         "seq_swaps": 0, "seq_restores": 0,
                         "spill_out_pages": 0, "spill_in_pages": 0,
                         "host_demotions": 0,
                         "retained_hits": 0, "retained_tokens": 0,
                         "retained_reclaimed": 0,
                         "prefetch_allocs": 0, "prefetch_hits": 0}
        #: set whenever the exported tables changed; the engine reads it to
        #: decide when to re-push ``cache["vm"]`` (and clears it after)
        self.dirty = True
        if policy == "reserved":
            for s in range(n_seqs):
                for lp in range(max_lpages):
                    f = self.allocator.alloc()
                    self.block_table[s, lp] = f
                    self.frame_lpage[f] = lp

    @property
    def share_prefixes(self) -> bool:
        return self._share_prefixes

    @share_prefixes.setter
    def share_prefixes(self, value: bool) -> None:
        """Callers may toggle sharing after construction (benches do);
        the toggle changes every future match, so it advances the
        epoch."""
        self._share_prefixes = bool(value) and self.policy == "on_demand"
        self.epoch += 1

    def _mark_dirty(self) -> None:
        """Tables changed: the engine must re-push ``cache["vm"]``, and
        any cached admission score is stale."""
        self.dirty = True
        self.epoch += 1

    # -- allocation with retention-pool reclaim --------------------------------
    def _alloc_frame(self) -> int:
        """Allocate a device frame, reclaiming LRU retained entries under
        pool pressure before giving up (live sequences always outrank the
        retention pool)."""
        while True:
            try:
                f = self.allocator.alloc()
                self.counters["allocs"] += 1
                return f
            except OutOfFrames:
                if not self._reclaim_retained():
                    raise

    def _reclaim_retained(self, want: int = 1) -> int:
        """Drop least-recently-used retention entries until ``want`` device
        frames were actually freed.  An entry whose every frame is still
        shared with a live sequence would free nothing -- it is skipped,
        not destroyed, so pool pressure cannot wipe out retained prefixes
        for zero capacity gain.  Returns the number freed."""
        freed = 0
        while freed < want and self._reclaimable() > 0:
            # prefer the oldest entry that frees something on its own; fall
            # back to plain LRU for frames shared ACROSS entries, which only
            # free once every holding entry is gone
            if self._tree is not None:
                keys = self._tree.lru_keys()
                key = next(
                    (k for k in keys
                     if self._pages_freeable(self._tree.pool_pages(k)) > 0),
                    keys[0])
                pages = self._tree.remove_pool(key)
            else:
                key = next((k for k, e in self._retained.items()
                            if self._pages_freeable(e.pages) > 0),
                           next(iter(self._retained)))
                pages = self._retained.pop(key).pages
            freed += self._drop_pages(pages)
            self.counters["retained_reclaimed"] += 1
        return freed

    def _pages_freeable(self, pages: list) -> int:
        """Device frames dropping this page list would actually free."""
        counts: dict[int, int] = {}
        for _, f in pages:
            counts[f] = counts.get(f, 0) + 1
        return sum(1 for f, n in counts.items()
                   if self.allocator.refcount(f) == n
                   and self.allocator.pin_count(f) == 0)

    def _drop_pages(self, pages: list) -> int:
        freed = 0
        for _, f in pages:
            before = self.allocator.refcount(f)
            self.allocator.deref(f)
            self.counters["frees"] += 1
            freed += int(before == 1)
        self._mark_dirty()
        return freed

    def _reclaimable(self, exclude_key: int | None = None) -> int:
        """Device frames the retention pool would free if fully drained.

        ``exclude_key`` names a retained entry the caller intends to SHARE
        from -- its pages must stay resident, so they are not headroom (an
        admission must not count the same frame both as an already-present
        prefix page and as drainable slack).  On the tree index this reads
        the maintained per-frame counts (O(distinct pool frames)); the
        linear oracle rebuilds them per call."""
        if self._tree is not None:
            return self._tree.reclaimable(self.allocator, exclude_key)
        counts: dict[int, int] = {}
        for key, entry in self._retained.items():
            if key == exclude_key:
                continue
            for _, f in entry.pages:
                counts[f] = counts.get(f, 0) + 1
        return sum(1 for f, n in counts.items()
                   if self.allocator.refcount(f) == n
                   and self.allocator.pin_count(f) == 0)

    # -- admission accounting -------------------------------------------------
    def pages_for(self, n_tokens: int) -> int:
        return -(-max(n_tokens, 1) // self.page_slots)

    def _match_prefix(self, tokens: np.ndarray):
        """Longest common prefix with a retained prompt or a live sequence's
        prompt.  The retention pool is consulted first; a live donor only
        wins with a strictly longer match.

        Returns (match_len, donor) where donor is ("pool", key) or
        ("live", seq); (0, None) when sharing is off or nothing matches.
        On the tree index this is one O(len(tokens)) radix descent; the
        linear oracle scans every candidate."""
        if not self.share_prefixes or len(tokens) == 0:
            return 0, None
        if self._tree is not None:
            return self._tree.lookup(tokens)
        best, donor = 0, None

        def common(p):
            m = min(len(p), len(tokens))
            if m <= best:
                return 0
            eq = p[:m] == tokens[:m]
            return m if eq.all() else int(np.argmin(eq))

        for key, entry in self._retained.items():
            c = common(entry.tokens)
            if c > best:
                best, donor = c, ("pool", key)
        for seq, p in self._prompts.items():
            c = common(p)
            if c > best:
                best, donor = c, ("live", seq)
        return best, donor

    def _admit_need(self, tokens: np.ndarray, tag: int | None):
        """(frames needed, shared prefix tokens, swap pages, spill pages,
        pool entry the admission would share from)."""
        if self.policy == "reserved":
            return 0, 0, 0, 0, None
        if tag is not None and tag in self._swapped:
            rec = self._swapped[tag]
            pages = len(rec.pages)
            spill = sum(1 for _, f in rec.pages
                        if self.allocator.is_spill_frame(f))
            return pages, 0, pages, spill, None
        n = max(len(tokens), 1)
        match, donor = self._match_prefix(np.asarray(tokens))
        pool_key = donor[1] if donor is not None and donor[0] == "pool" \
            else None
        if n <= match:
            return 0, match, 0, 0, pool_key  # whole prompt shared: re-run only
        return (self.pages_for(n) - match // self.page_slots, match, 0, 0,
                pool_key)

    def admit_frames_needed(self, tokens: np.ndarray,
                            tag: int | None = None) -> int:
        """Frames the admission of ``tokens`` will allocate: the pages a
        prefill needs after prefix sharing, or -- for a swapped-out request
        identified by ``tag`` -- the pages its restore will swap back in."""
        return self._admit_need(tokens, tag)[0]

    def admission_cost(self, tokens: np.ndarray,
                       tag: int | None = None) -> AdmissionCost:
        """The residency cost terms of admitting ``tokens`` right now: the
        frames it must allocate, the prefix tokens whose prefill it would
        skip, and the PCIe pages a swap-resume (identified by ``tag``)
        would move.  Pure query -- no state is touched, so the scheduler
        may score every waiting request each step."""
        need, match, swap_pages, spill_pages, pool_key = \
            self._admit_need(tokens, tag)
        return AdmissionCost(
            new_frames=need, shared_tokens=int(match),
            swap_in_pages=swap_pages, has_swap=swap_pages > 0,
            admissible=need <= (self.allocator.free_count()
                                + self._reclaimable(exclude_key=pool_key)),
            spill_in_pages=spill_pages)

    def can_admit(self, tokens: np.ndarray, tag: int | None = None) -> bool:
        """Admission check: free frames plus what draining the retention
        pool would free must cover the request's immediate need.  A
        retained entry the prefix match would share from is NOT drainable
        headroom -- its pages have to stay resident to be shared."""
        return self.admission_cost(tokens, tag).admissible

    # -- sequence lifecycle ---------------------------------------------------
    def begin_seq(self, seq: int, tokens: np.ndarray) -> int:
        """Register ``seq`` with prompt ``tokens``; share any common-prefix
        frames with a retained entry or a live donor.  Returns the number of
        leading prompt tokens whose KV is already present (prefill may
        resume after them).
        """
        tokens = np.asarray(tokens, np.int32).ravel()
        if self.policy == "reserved":
            self.shared_len[seq] = 0
            return 0
        self._mark_dirty()
        assert (self.block_table[seq] < 0).all(), f"seq {seq} already mapped"
        match, donor = self._match_prefix(tokens)
        ps = self.page_slots
        n_pages = match // ps + (1 if match % ps else 0)
        if donor is not None and n_pages:
            kind, key = donor
            if kind == "pool":
                if self._tree is not None:
                    frames = dict(self._tree.pool_pages(key))
                    self._tree.touch_pool(key)
                else:
                    entry = self._retained[key]
                    self._retained.move_to_end(key)
                    frames = dict(entry.pages)
                self.counters["retained_hits"] += 1
                self.counters["retained_tokens"] += match
            else:
                frames = {lp: int(self.block_table[key, lp])
                          for lp in range(n_pages)}
            for lp in range(n_pages):
                f = frames[lp]
                assert f >= 0, (donor, lp)
                self.allocator.ref(f)
                self.allocator.pin(f)
                self.block_table[seq, lp] = f
                self.counters["shared_frames"] += 1
        self.shared_len[seq] = match
        self.counters["shared_tokens"] += match
        if self.share_prefixes:
            self._prompts[seq] = tokens.copy()
            if self._tree is not None:
                self._tree.insert_live(seq, tokens)
        return match

    def ensure_writable(self, seq: int, pos: int) -> list[CowCopy]:
        """Make position ``pos`` of ``seq`` backed by a writable frame.

        Allocates the frame if the logical page is unmapped; copy-on-writes
        it if the page is shared and ``pos`` diverges from the shared prefix
        (first divergent write).  May raise :class:`OutOfFrames` -- state is
        untouched in that case so the caller can preempt and retry (the
        retention pool is reclaimed LRU-first before the raise).  Returns
        the device page copies the caller must apply before decoding.
        """
        lp = pos // self.page_slots
        assert 0 <= lp < self.max_lpages, (seq, pos, lp)
        f = int(self.block_table[seq, lp])
        if f < 0:
            nf = self._alloc_frame()
            self.allocator.pin(nf)
            self.block_table[seq, lp] = nf
            self.frame_lpage[nf] = lp
            self._mark_dirty()
            return []
        if (seq, lp) in self._prefetched:
            self._prefetched.discard((seq, lp))
            self.counters["prefetch_hits"] += 1
        if pos >= int(self.shared_len[seq]) and self.allocator.is_shared(f):
            nf = self._alloc_frame()             # raises before any mutation
            self.allocator.pin(nf)
            self.allocator.unpin(f)
            self.allocator.deref(f)
            self.block_table[seq, lp] = nf
            self.frame_lpage[nf] = lp
            self.counters["cow_copies"] += 1
            self._mark_dirty()
            return [CowCopy(src=f, dst=nf)]
        return []

    def prefetch(self, seq: int, length: int) -> bool:
        """Async next-page prefetch: called after the token at ``length - 1``
        was scheduled, allocates the ``length // page_slots`` frame one
        token *before* the boundary write would fault it in.  Opportunistic:
        pool pressure (or an already-mapped page) makes it a no-op -- the
        retention pool is never reclaimed for a speculative page, and a
        prefetch never takes the frames live sequences' *mandatory* growth
        may need this step (headroom gate: one frame per live sequence
        stays untouched, so a prefetch cannot be the reason a sequence gets
        preempted).  Returns True when a frame was pre-allocated."""
        if self.policy == "reserved":
            return False
        nxt = length                       # position the NEXT token writes
        if nxt >= self.max_lpages * self.page_slots or nxt % self.page_slots:
            return False                   # not one-before-a-boundary
        lp = nxt // self.page_slots
        if self.block_table[seq, lp] >= 0:
            return False
        live = int((self.block_table >= 0).any(axis=1).sum())
        if self.allocator.free_count() <= live:
            return False                   # leave mandatory-growth headroom
        try:
            nf = self.allocator.alloc()    # no retention reclaim: speculative
        except OutOfFrames:
            return False
        self.counters["allocs"] += 1
        self.counters["prefetch_allocs"] += 1
        self.allocator.pin(nf)
        self.block_table[seq, lp] = nf
        self.frame_lpage[nf] = lp
        self._prefetched.add((seq, lp))
        self._mark_dirty()
        return True

    def stage_fused_run(self, seqs: Sequence[int], lengths: Sequence[int],
                        limit: int) -> FusedRunPlan:
        """Plan a fused multi-step decode run for the slots ``seqs``
        (current lengths ``lengths``), simulating the stepwise host loop
        k-major / slot-minor -- exactly the event order the engine's
        per-step path would produce -- and PRE-STAGING the prefetch
        allocations that loop would have made, so page boundaries no longer
        end the run.

        Step ``k`` (0-based) writes position ``lengths[i] + k`` of every
        slot.  The run ends before the first step whose write would need
        host action that cannot be staged: an unmapped (and unstaged) page
        -- a prior prefetch declined, so growth must allocate or preempt --
        a first divergent write to a shared page (copy-on-write), or the
        table running out of logical pages.  A boundary whose prefetch the
        stepwise loop would have *granted* is staged instead (allocator
        alloc + pin happen NOW, so the headroom gate and free-list order
        are byte-identical to stepwise; the table mapping and all counters
        are deferred); one it would have *declined* ends the run exactly
        where stepwise growth would have faulted.

        The caller owns the returned plan: after the device loop reports
        how many steps actually executed, :meth:`commit_fused_run` replays
        mappings + counters for the reached stagings and silently returns
        the unreached frames; :meth:`cancel_fused_run` returns all of them
        (allocator state is restored exactly -- LIFO free list, reverse
        undo order).

        Under the reserved policy every page is statically mapped, never
        shared and never prefetched, so the plan is ``limit`` steps with
        nothing staged.
        """
        limit = max(int(limit), 0)
        if self.policy == "reserved":
            return FusedRunPlan(n=limit, allocs=[], hits=[])
        ps = self.page_slots
        seq_set = set(int(s) for s in seqs)
        pending = {(s, lp) for (s, lp) in self._prefetched if s in seq_set}
        staged: dict[tuple[int, int], int] = {}
        allocs: list[StagedPrefetch] = []
        hits: list[PendingHit] = []
        shared = {int(s): int(self.shared_len[int(s)]) for s in seqs}
        starts = [(int(s), int(L)) for s, L in zip(seqs, lengths)]
        n = 0
        while n < limit:
            k = n
            # write phase of step k, slots in engine step order
            broke = False
            for s, L0 in starts:
                pos = L0 + k
                lp = pos // ps
                if lp >= self.max_lpages:
                    broke = True
                    break
                key = (s, lp)
                if key not in staged:
                    f = int(self.block_table[s, lp])
                    if f < 0:
                        broke = True     # growth would allocate (or preempt)
                        break
                    if pos >= shared[s] and self.allocator.is_shared(f):
                        broke = True     # first divergent write: COW
                        break
                if key in pending:       # first write settles hit accounting
                    hits.append(PendingHit(seq=s, lpage=lp, k_hit=k))
                    pending.discard(key)
            if broke:
                break
            n = k + 1
            # post-step prefetch hooks of step k, same slot order
            declined = False
            for s, L0 in starts:
                nl = L0 + k + 1          # position the NEXT token writes
                if nl % ps or nl >= self.max_lpages * ps:
                    continue
                lp = nl // ps
                if (s, lp) in staged or int(self.block_table[s, lp]) >= 0:
                    continue
                live = int((self.block_table >= 0).any(axis=1).sum())
                if self.allocator.free_count() <= live:
                    declined = True      # stepwise would decline too; the
                    continue             # write at k+1 then faults: run ends
                try:
                    nf = self.allocator.alloc()   # no reclaim: speculative
                except OutOfFrames:
                    declined = True
                    continue
                self.allocator.pin(nf)
                staged[(s, lp)] = nf
                allocs.append(StagedPrefetch(seq=s, lpage=lp, frame=nf,
                                             k_alloc=k))
            if declined:
                break
        return FusedRunPlan(n=n, allocs=allocs, hits=hits)

    def commit_fused_run(self, plan: FusedRunPlan, n_done: int) -> None:
        """Settle a staged plan after the device loop executed ``n_done``
        steps: replay table mappings and prefetch counters for everything
        the run actually reached, byte-identically to what the stepwise
        loop would have recorded, and silently return unreached frames.

        A staged frame whose allocating step ran (``k_alloc < n_done``)
        exists exactly as a stepwise prefetch would: allocs/prefetch_allocs
        count it, the block table maps it, and -- if its first write also
        ran -- prefetch_hits settles immediately; otherwise it stays in the
        pending-prefetch set for a later :meth:`ensure_writable` to claim.
        Pre-run pending pages written inside the run settle their hits the
        same way.  Frames whose allocating step never ran are returned with
        no counter traffic (stepwise would never have allocated them)."""
        if self.policy == "reserved":
            return
        n_done = int(n_done)
        undo = []
        for st in plan.allocs:
            if st.k_alloc >= n_done:
                undo.append(st)
                continue
            self.counters["allocs"] += 1
            self.counters["prefetch_allocs"] += 1
            self.block_table[st.seq, st.lpage] = st.frame
            self.frame_lpage[st.frame] = st.lpage
            if st.k_hit < n_done:
                self.counters["prefetch_hits"] += 1
            else:
                self._prefetched.add((st.seq, st.lpage))
            self._mark_dirty()
        for h in plan.hits:
            if h.k_hit < n_done:
                self._prefetched.discard((h.seq, h.lpage))
                self.counters["prefetch_hits"] += 1
        for st in reversed(undo):
            self.allocator.unpin(st.frame)
            self.allocator.deref(st.frame)

    def cancel_fused_run(self, plan: FusedRunPlan) -> None:
        """Return every staged frame of an abandoned plan.  Reverse order
        against the LIFO free list, so allocator state -- including the
        order future allocations pop frames -- is exactly as if the plan
        had never been staged."""
        for st in reversed(plan.allocs):
            self.allocator.unpin(st.frame)
            self.allocator.deref(st.frame)

    def noop_run(self, seq: int, length: int, limit: int) -> int:
        """How many consecutive decode steps, starting from ``length``,
        the fused path can run for ``seq`` without unplanned host-side
        frame management -- pure query: stages a single-slot plan and
        immediately cancels it, restoring allocator state exactly.  Since
        the staging refactor a grantable boundary prefetch no longer ends
        the run (it would be staged), so the answer counts through page
        boundaries; unmapped-after-declined-prefetch, COW, and
        end-of-table still bound it."""
        plan = self.stage_fused_run([seq], [length], limit)
        self.cancel_fused_run(plan)
        return plan.n

    # -- residency: preemption swap-out / resume swap-in ----------------------
    def _demote_candidates(self):
        """Host-resident pages in demotion-priority order: snapshots of
        shared/retained *prefix* pages first (their device copy usually
        still serves the retention pool or a live sharer, so these are the
        coldest bytes on host), then everything else -- both classes LRU by
        preemption order (``_swapped`` insertion order is the clock).
        Yields ``(record, page_index, host_frame)``."""
        for prefix_class in (True, False):
            for rec in self._swapped.values():
                for i, (lp, f) in enumerate(rec.pages):
                    if not self.allocator.is_host_frame(f):
                        continue            # already spilled
                    if (i < rec.prefix_pages) == prefix_class:
                        yield rec, i, f

    def _demote_host(self, want: int) -> int:
        """HOST -> SPILL: free ``want`` host frames by demoting parked
        payloads into the spill store.  Returns the number actually freed
        (< ``want`` iff the spill tier is full or disabled -- the caller
        then falls back to recompute).  Candidate order is
        :meth:`_demote_candidates`; record page lists are rewritten in
        place so a later restore transparently promotes from whichever
        tier holds each page."""
        if self.spill is None:
            return 0
        freed = 0
        for rec, i, hf in list(self._demote_candidates()):
            if freed >= want:
                break
            try:
                sf = self.allocator.alloc_spill()
            except OutOfSpillFrames:
                break
            self.spill.put(sf, self._host_payloads.pop(hf))
            self.allocator.free_host(hf)
            rec.pages[i] = (rec.pages[i][0], sf)
            freed += 1
            self.counters["spill_out_pages"] += 1
        if freed:
            self.counters["host_demotions"] += 1
        return freed

    def evict_seq(self, seq: int, tag: int) -> int | None:
        """DEVICE -> HOST: park every frame ``seq`` holds in the host
        backing store under ``tag`` and release the device frames.

        Returns the number of pages swapped out, or None when swapping is
        unavailable (reserved policy, swapping disabled, no page-IO bound,
        or BOTH backing tiers are full -- host pressure first demotes host
        pages to the spill store, so recompute is genuinely the last
        resort).  Shared prefix frames are snapshotted before the deref, so
        the record is self-contained even if every other owner disappears
        before the restore."""
        if (self.policy == "reserved" or not self.swap_enabled
                or self.page_io is None or tag in self._swapped):
            return None
        row = self.block_table[seq]
        lpages = [lp for lp in range(self.max_lpages) if row[lp] >= 0]
        short = len(lpages) - self.allocator.host_free_count()
        if short > 0 and self._demote_host(short) < short:
            return None                     # both tiers full: recompute
        shared = int(self.shared_len[seq])
        frames = [int(row[lp]) for lp in lpages]
        payloads = self.page_io.read(frames)
        pages = []
        for lp, f, payload in zip(lpages, frames, payloads):
            hf = self.allocator.alloc_host()
            self._host_payloads[hf] = payload
            pages.append((lp, hf))
            self.allocator.unpin(f)
            self.allocator.deref(f)
            self.counters["frees"] += 1
        self._swapped[tag] = _SwapRecord(
            pages=pages,
            prefix_pages=sum(1 for lp, _ in pages
                             if lp * self.page_slots < shared))
        self._prompts.pop(seq, None)
        if self._tree is not None:
            self._tree.remove_live(seq)
        self._prefetched = {(s, lp) for s, lp in self._prefetched if s != seq}
        self.block_table[seq] = -1
        self.shared_len[seq] = 0
        self.counters["seq_swaps"] += 1
        self.counters["swap_out_pages"] += len(pages)
        self._mark_dirty()
        return len(pages)

    def has_swap(self, tag: int | None) -> bool:
        return tag is not None and tag in self._swapped

    def _unpark_payload(self, bf: int):
        """Release backing frame ``bf`` and return its payload, whichever
        tier holds it.  A spill frame is the two-hop promotion's first leg:
        the bytes are deserialized into host memory (SPILL -> HOST) before
        the caller's page-IO write moves them on to the device."""
        if self.allocator.is_spill_frame(bf):
            payload = self.spill.pop(bf)
            self.allocator.free_spill(bf)
            self.counters["spill_in_pages"] += 1
            return payload
        payload = self._host_payloads.pop(bf)
        self.allocator.free_host(bf)
        return payload

    def restore_seq(self, seq: int, tag: int, tokens=None) -> int:
        """HOST (or SPILL -> HOST) -> DEVICE: rebuild ``seq``'s block table
        from the swap record ``tag``, writing the parked payloads back into
        fresh device frames through the page-IO callback.  Spilled pages
        take the two-hop promotion transparently.  Raises
        :class:`OutOfFrames` (after reclaiming the retention pool) if the
        device pool cannot hold the pages; the record is left intact in
        that case.  Returns the number of pages swapped back in."""
        rec = self._swapped[tag]
        need = len(rec.pages)
        if need > self.allocator.free_count():
            self._reclaim_retained(need - self.allocator.free_count())
        if need > self.allocator.free_count():
            raise OutOfFrames(
                f"restore of {need} pages, {self.allocator.free_count()} "
                f"free")
        assert (self.block_table[seq] < 0).all(), f"seq {seq} already mapped"
        assignments = []
        for lp, bf in rec.pages:
            f = self._alloc_frame()
            self.allocator.pin(f)
            self.block_table[seq, lp] = f
            self.frame_lpage[f] = lp
            assignments.append((f, self._unpark_payload(bf)))
        self.page_io.write(assignments)
        del self._swapped[tag]
        self.shared_len[seq] = 0            # every restored frame is private
        if self.share_prefixes and tokens is not None and len(tokens):
            self._prompts[seq] = np.asarray(tokens, np.int32).ravel().copy()
            if self._tree is not None:
                self._tree.insert_live(seq, self._prompts[seq])
        self.counters["seq_restores"] += 1
        self.counters["swap_in_pages"] += len(rec.pages)
        self._mark_dirty()
        return len(rec.pages)

    def drop_swap(self, tag: int) -> None:
        """Discard a swap record (request cancelled / completed elsewhere):
        backing frames return to their tier's pool, payloads are dropped."""
        rec = self._swapped.pop(tag, None)
        if rec is None:
            return
        self.epoch += 1     # the tag's swap-resume cost just disappeared
        for _, bf in rec.pages:
            if self.allocator.is_spill_frame(bf):
                self.spill.drop(bf)
                self.allocator.free_spill(bf)
            else:
                self._host_payloads.pop(bf, None)
                self.allocator.free_host(bf)

    # -- completion / retention ------------------------------------------------
    def release_seq(self, seq: int, completed: bool = False) -> None:
        """Drop every reference ``seq`` holds (no-op under ``reserved`` --
        the static tables ARE the reservation).  On completion with
        retention enabled, the pages covering the prompt transfer to the
        bounded LRU retention pool instead of being freed, so the next
        request with the same prefix skips their prefill."""
        if self.policy == "reserved":
            return
        self._mark_dirty()
        prompt = self._prompts.pop(seq, None)
        if self._tree is not None:
            self._tree.remove_live(seq)
        self._prefetched = {(s, lp) for s, lp in self._prefetched if s != seq}
        row = self.block_table[seq]
        keep: dict[int, int] = {}
        if (completed and self.share_prefixes and self.retain_frames > 0
                and prompt is not None and len(prompt)):
            n_keep = self.pages_for(len(prompt))
            keep = {lp: int(row[lp]) for lp in range(n_keep) if row[lp] >= 0}
        for lp in range(self.max_lpages):
            f = int(row[lp])
            if f < 0:
                continue
            self.allocator.unpin(f)
            if lp in keep:
                continue                    # ref transfers to the pool
            self.allocator.deref(f)
            self.counters["frees"] += 1
        if keep:
            self._retain(prompt, sorted(keep.items()))
        self.block_table[seq] = -1
        self.shared_len[seq] = 0

    #: pre-residency name for the release path (completion semantics were
    #: implicit before; plain frees, no retention)
    def free_seq(self, seq: int) -> None:
        self.release_seq(seq, completed=False)

    def _retain(self, prompt: np.ndarray, pages: list) -> None:
        """Insert a completed prompt's pages into the LRU retention pool,
        deduplicating identical prompts and enforcing the frame budget.  A
        prompt that alone exceeds the budget is rejected up front -- it
        must not flush every smaller (and still useful) entry first."""
        if len(pages) > self.retain_frames:
            for _, f in pages:
                self.allocator.deref(f)
                self.counters["frees"] += 1
            self._mark_dirty()
            return
        if self._tree is not None:
            dup = self._tree.find_pool(prompt)
            if dup is not None:
                # same prompt already retained: keep the existing terminal
                # (its frames are the shared ones), drop the new refs
                self._tree.touch_pool(dup)
                for _, f in pages:
                    self.allocator.deref(f)
                    self.counters["frees"] += 1
                return
            self._retain_key += 1
            self._tree.insert_pool(self._retain_key, prompt, pages)
            total = self._tree.pool_frames_total
            while total > self.retain_frames:
                old = self._tree.remove_pool(self._tree.oldest_pool())
                total -= len(old)
                self._drop_pages(old)
                self.counters["retained_reclaimed"] += 1
            return
        for key, entry in self._retained.items():
            if len(entry.tokens) == len(prompt) and \
                    bool((entry.tokens == prompt).all()):
                # same prompt already retained: keep the existing entry (its
                # frames are the shared ones), drop the new refs
                self._retained.move_to_end(key)
                for _, f in pages:
                    self.allocator.deref(f)
                    self.counters["frees"] += 1
                return
        self._retain_key += 1
        self._retained[self._retain_key] = _RetainEntry(
            tokens=prompt.copy(), pages=pages)
        total = sum(len(e.pages) for e in self._retained.values())
        while total > self.retain_frames:
            _, old = self._retained.popitem(last=False)
            total -= len(old.pages)
            self._drop_pages(old.pages)
            self.counters["retained_reclaimed"] += 1

    def drain_retained(self) -> int:
        """Release every retention-pool reference; returns entries dropped
        (shutdown: a drained pool counts as zero leaked frames)."""
        if self._tree is not None:
            keys = self._tree.lru_keys()
            for key in keys:
                self._drop_pages(self._tree.remove_pool(key))
            return len(keys)
        n = len(self._retained)
        while self._retained:
            _, entry = self._retained.popitem(last=False)
            self._drop_pages(entry.pages)
        return n

    # -- exported tables (ride in cache["vm"] into the kernel) ----------------
    def frame_ro(self) -> np.ndarray:
        """Shared bit [n_frames]: refcount > 1, writes must be dropped."""
        return self.allocator.shared_mask()

    def tables(self) -> dict:
        return {"block_table": self.block_table.copy(),
                "frame_lpage": self.frame_lpage.copy(),
                "frame_ro": self.frame_ro()}

    # -- introspection / shutdown ---------------------------------------------
    def used_count(self) -> int:
        return self.allocator.used_count()

    def free_count(self) -> int:
        return self.allocator.free_count()

    def stats(self) -> dict:
        if self._tree is not None:
            retained_entries = self._tree.pool_count
            retained_frames = self._tree.pool_frames_total
        else:
            retained_entries = len(self._retained)
            retained_frames = sum(len(e.pages)
                                  for e in self._retained.values())
        return {**self.allocator.stats(), **self.counters,
                "policy": self.policy, "live_seqs": len(self._prompts),
                "prefix_index": self.prefix_index,
                "retained_entries": retained_entries,
                "retained_frames": retained_frames,
                "swapped_seqs": len(self._swapped),
                **(self.spill.stats() if self.spill is not None else {})}

    def leak_counts(self) -> dict:
        """Frames still allocated per tier -- the leak report.  Only
        meaningful after :meth:`shutdown` drained the passive owners."""
        return {"device": self.allocator.used_count(),
                "host": self.allocator.host_used_count(),
                "spill": self.allocator.spill_used_count()}

    def shutdown(self) -> int:
        """Release the reserved-policy reservation, drain the retention pool
        and any unclaimed swap records, and report the number of frames
        still referenced across ALL tiers (the leak count -- 0 iff every
        sequence was released).  A host- or spill-store leak fails shutdown
        exactly like a device leak: a parked payload nobody can ever
        restore is capacity lost for the process lifetime, which on the
        backing tiers is silent (no allocation ever fails loudly there
        until the store fills)."""
        if self.policy == "reserved":
            for s in range(self.n_seqs):
                for lp in range(self.max_lpages):
                    f = int(self.block_table[s, lp])
                    if f >= 0:
                        self.allocator.deref(f)
            self.block_table[:] = -1
        self.drain_retained()
        for tag in list(self._swapped):
            self.drop_swap(tag)
        if self.spill is not None:
            self.spill.drain()              # payloads whose frame id leaked
        return sum(self.leak_counts().values())
