"""Refcounted free-list frame allocator over the EMem physical page pool.

Allocation is a control-plane operation (it happens at request admission /
completion on the host, never inside a jitted step), so the allocator is
plain Python over numpy -- the data plane only ever sees the frame indices
it hands out.  LIFO free-list: recently freed frames are reused first, which
keeps the hot-page cache warm across free+realloc churn.

Every live frame carries a *reference count*: ``alloc`` hands out a frame at
refcount 1, ``ref`` adds an owner (prefix sharing -- the same physical frame
backs a common prompt prefix of several sequences), and ``free``/``deref``
drops one owner, returning the frame to the free list only when the last
owner lets go.  A frame with refcount > 1 is *shared* and must be treated as
read-only by its owners (copy-on-write is the BlockManager's job).  A
``free`` of an already-free frame raises -- a double free would push the
same frame onto the free list twice and hand it to two owners.

Residency (the tiered frame lifecycle,
``FREE -> DEVICE -> HOST -> SPILL -> FREE``):

  * **device frames** ``[0, n_frames)`` live in the emulated device memory;
    ``alloc`` moves one FREE -> DEVICE, the last ``free`` DEVICE -> FREE.
  * **host frames** ``[n_frames, n_frames + n_host_frames)`` are slots in a
    host (CPU DRAM) backing store one PCIe hop below the pool.  They are a
    *separate id space* -- a swapped-out page's contents move to a host
    frame while its device frame returns to the free list, so swapping
    genuinely frees device capacity.  ``alloc_host``/``free_host`` manage
    them; refcounts are tracked in the same array.
  * **spill frames** ``[n_frames + n_host_frames, total)`` are slots in the
    third-tier spill store (file/bytes-backed, one more hop below host
    DRAM).  When the host store fills, a demotion policy moves host pages
    down here instead of dropping them -- HOST -> SPILL -- and a swap-in
    promotes them back up (SPILL -> HOST -> DEVICE).
    ``alloc_spill``/``free_spill`` manage them.
  * **pins** mark device frames that back *live* sequences (actively being
    decoded into) and therefore must not be reclaimed.  A frame that is
    allocated but unpinned -- e.g. held only by the prefix-retention pool --
    is an *eviction candidate*: ``eviction_candidates()`` lists exactly the
    frames a residency policy may reclaim under pool pressure.

The three id spaces are disjoint by construction, and every free path
validates its tier: ``free`` accepts only device frames, ``free_host`` only
host frames, ``free_spill`` only spill frames.  (``free_host`` used to be a
bare alias of ``free``, which silently returned a device id passed to it to
the *device* free list -- a cross-tier double-hand-out waiting to happen.)
"""
from __future__ import annotations

import dataclasses

import numpy as np

#: Residency states of a frame id (see module docstring).
RES_FREE = "free"
RES_DEVICE = "device"
RES_HOST = "host"
RES_SPILL = "spill"


class OutOfFrames(RuntimeError):
    """The device pool has no free frame left."""


class OutOfHostFrames(RuntimeError):
    """The host backing store has no free frame left."""


class OutOfSpillFrames(RuntimeError):
    """The spill store has no free frame left."""


@dataclasses.dataclass
class FrameAllocator:
    """LIFO free-list with per-frame refcounts over device frames
    ``[0, n_frames)``, host frames ``[n_frames, n_frames+n_host_frames)``
    and spill frames ``[n_frames+n_host_frames, total)``.
    """
    n_frames: int
    n_host_frames: int = 0
    n_spill_frames: int = 0

    def __post_init__(self):
        if self.n_frames <= 0:
            raise ValueError("n_frames must be positive")
        if self.n_host_frames < 0:
            raise ValueError("n_host_frames must be >= 0")
        if self.n_spill_frames < 0:
            raise ValueError("n_spill_frames must be >= 0")
        self._free: list[int] = list(range(self.n_frames - 1, -1, -1))
        host_end = self.n_frames + self.n_host_frames
        self._free_host: list[int] = list(
            range(host_end - 1, self.n_frames - 1, -1))
        total = host_end + self.n_spill_frames
        self._free_spill: list[int] = list(
            range(total - 1, host_end - 1, -1))
        self._refs = np.zeros(total, np.int32)
        #: pin count per frame: >0 means a live sequence is decoding into it
        #: (never an eviction candidate).  Only device frames are pinned.
        self._pins = np.zeros(total, np.int32)

    # -- alloc / ref / free ---------------------------------------------------
    def alloc(self) -> int:
        """FREE -> DEVICE: hand out a device frame at refcount 1."""
        if not self._free:
            raise OutOfFrames(f"all {self.n_frames} frames allocated")
        f = self._free.pop()
        self._refs[f] = 1
        return f

    def bulk_alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise OutOfFrames(
                f"requested {n} frames, only {len(self._free)} free")
        return [self.alloc() for _ in range(n)]

    def alloc_host(self) -> int:
        """FREE -> HOST: hand out a host backing-store frame at refcount 1."""
        if not self._free_host:
            raise OutOfHostFrames(
                f"all {self.n_host_frames} host frames allocated")
        f = self._free_host.pop()
        self._refs[f] = 1
        return f

    def alloc_spill(self) -> int:
        """FREE -> SPILL: hand out a spill-store frame at refcount 1."""
        if not self._free_spill:
            raise OutOfSpillFrames(
                f"all {self.n_spill_frames} spill frames allocated")
        f = self._free_spill.pop()
        self._refs[f] = 1
        return f

    def ref(self, frame: int) -> int:
        """Add an owner to a live frame; returns the new refcount."""
        self._check_range(frame)
        if self._refs[frame] <= 0:
            raise ValueError(f"ref of free frame {frame}")
        self._refs[frame] += 1
        return int(self._refs[frame])

    def refcount(self, frame: int) -> int:
        self._check_range(frame)
        return int(self._refs[frame])

    def is_shared(self, frame: int) -> bool:
        return self.refcount(frame) > 1

    def _release(self, frame: int) -> None:
        """Drop one reference; the frame returns to its tier's free list
        only when the last owner drops it.  Freeing an already-free frame
        raises (a double free would hand the same frame to two owners), as
        does dropping the last reference to a frame still pinned (a live
        sequence is decoding into it -- recycling it would silently corrupt
        that sequence's pages)."""
        if self._refs[frame] <= 0:
            raise ValueError(f"double free of frame {frame}")
        if self._refs[frame] == 1 and self._pins[frame] > 0:
            raise ValueError(f"free of pinned frame {frame}")
        self._refs[frame] -= 1
        if self._refs[frame] == 0:
            {"device": self._free, "host": self._free_host,
             "spill": self._free_spill}[self.tier_of(frame)].append(frame)

    def free(self, frame: int) -> None:
        """DEVICE -> FREE (last owner).  Rejects non-device frame ids: a
        host or spill id freed here would land on the device free list and
        be handed out as a device frame (the tier-confusion bug
        ``free_host = free`` used to permit in the other direction)."""
        self._check_tier(frame, "device")
        self._release(frame)

    #: ``deref`` is the refcount-flavored name for the same operation.
    deref = free

    def free_host(self, frame: int) -> None:
        """HOST -> FREE (last owner).  Rejects non-host frame ids."""
        self._check_tier(frame, "host")
        self._release(frame)

    def free_spill(self, frame: int) -> None:
        """SPILL -> FREE (last owner).  Rejects non-spill frame ids."""
        self._check_tier(frame, "spill")
        self._release(frame)

    def bulk_free(self, frames) -> None:
        for f in frames:
            self.free(int(f))

    def _check_range(self, frame: int) -> None:
        total = self.n_frames + self.n_host_frames + self.n_spill_frames
        if not (0 <= frame < total):
            raise ValueError(f"frame {frame} out of range")

    def _check_tier(self, frame: int, tier: str) -> None:
        self._check_range(frame)
        actual = self.tier_of(frame)
        if actual != tier:
            raise ValueError(
                f"frame {frame} is a {actual}-tier id, not {tier} "
                f"(tier-confused free would corrupt the free lists)")

    # -- residency / eviction candidates --------------------------------------
    def tier_of(self, frame: int) -> str:
        """Which id space ``frame`` belongs to: device / host / spill."""
        self._check_range(frame)
        if frame < self.n_frames:
            return "device"
        if frame < self.n_frames + self.n_host_frames:
            return "host"
        return "spill"

    def is_host_frame(self, frame: int) -> bool:
        return self.tier_of(frame) == "host"

    def is_spill_frame(self, frame: int) -> bool:
        return self.tier_of(frame) == "spill"

    def residency(self, frame: int) -> str:
        """One of :data:`RES_FREE` / :data:`RES_DEVICE` / :data:`RES_HOST`
        / :data:`RES_SPILL`."""
        self._check_range(frame)
        if self._refs[frame] <= 0:
            return RES_FREE
        return {"device": RES_DEVICE, "host": RES_HOST,
                "spill": RES_SPILL}[self.tier_of(frame)]

    def pin(self, frame: int) -> None:
        """Mark a device frame as backing a live sequence (not evictable)."""
        self._check_range(frame)
        if frame >= self.n_frames:
            raise ValueError(
                f"{self.tier_of(frame)} frame {frame} cannot be pinned")
        if self._refs[frame] <= 0:
            raise ValueError(f"pin of free frame {frame}")
        self._pins[frame] += 1

    def unpin(self, frame: int) -> None:
        self._check_range(frame)
        if self._pins[frame] <= 0:
            raise ValueError(f"unpin of unpinned frame {frame}")
        self._pins[frame] -= 1

    def pin_count(self, frame: int) -> int:
        self._check_range(frame)
        return int(self._pins[frame])

    def eviction_candidates(self) -> list[int]:
        """Device frames that are allocated but unpinned -- held only by
        passive owners (e.g. the prefix-retention pool), reclaimable by a
        residency policy under pool pressure."""
        dev = np.arange(self.n_frames)
        mask = (self._refs[:self.n_frames] > 0) & \
            (self._pins[:self.n_frames] == 0)
        return [int(f) for f in dev[mask]]

    # -- stats ----------------------------------------------------------------
    def free_count(self) -> int:
        return len(self._free)

    def used_count(self) -> int:
        return self.n_frames - len(self._free)

    def host_free_count(self) -> int:
        return len(self._free_host)

    def host_used_count(self) -> int:
        return self.n_host_frames - len(self._free_host)

    def spill_free_count(self) -> int:
        return len(self._free_spill)

    def spill_used_count(self) -> int:
        return self.n_spill_frames - len(self._free_spill)

    def shared_count(self) -> int:
        """Frames currently owned by more than one sequence."""
        return int((self._refs[:self.n_frames] > 1).sum())

    def shared_mask(self) -> np.ndarray:
        """Boolean [n_frames]: refcount > 1 (read-only to every owner)."""
        return self._refs[:self.n_frames] > 1

    def occupancy(self) -> float:
        return self.used_count() / self.n_frames

    def fragmentation(self) -> float:
        """1 - (largest contiguous free run / total free frames).

        The emulated memory is random-access so fragmentation never blocks an
        allocation; the stat tracks how scattered the pool is, which feeds
        locality-sensitive policies (e.g. prefix-sharing placement).
        """
        n_free = len(self._free)
        if n_free == 0:
            return 0.0
        free_mask = self._refs[:self.n_frames] == 0
        best = run = 0
        for bit in free_mask:
            run = run + 1 if bit else 0
            best = max(best, run)
        return 1.0 - best / n_free

    def stats(self) -> dict:
        return {
            "n_frames": self.n_frames,
            "free": self.free_count(),
            "used": self.used_count(),
            "shared": self.shared_count(),
            "host_frames": self.n_host_frames,
            "host_used": self.host_used_count(),
            "spill_frames": self.n_spill_frames,
            "spill_used": self.spill_used_count(),
            "evictable": len(self.eviction_candidates()),
            "occupancy": self.occupancy(),
            "fragmentation": self.fragmentation(),
        }
