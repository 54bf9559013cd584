"""SpillStore: the third-tier backing store of the residency hierarchy.

The paper's emulation argument composes: just as the distributed small
memories emulate one large device memory, and host DRAM backs the device
pool one PCIe hop down, the spill store backs the *host* pool one more hop
down (disk, or any byte-addressable remote store).  Pages land here only
under host-tier pressure -- the BlockManager's demotion policy moves host
payloads down (``HOST -> SPILL``) instead of letting the engine fall off the
hierarchy into recompute -- and a swap-in promotes them back up
(``SPILL -> HOST -> DEVICE``).

Payloads are the same opaque objects the :class:`repro_torch.emem_vm.PageIO`
callbacks produce (per-layer page snapshots); the store serializes them to
``bytes`` on the way in, so residency here is genuinely *storage*, not a
parked Python reference:

  * default: an in-memory ``dict[frame, bytes]`` (the "remote memory"
    flavor -- still serialized, so the byte accounting is real);
  * with ``path``: one file per spill frame under that directory (the
    "disk" flavor), surviving the Python objects that created them.  In a
    process group of several ranks each rank spills under its own
    subdirectory ``rank<r>``: the ranks hold replicas of one store and
    must never share a file.

Keys are spill-frame ids from the :class:`FrameAllocator`'s spill id space;
the allocator owns *which* frames are live, this store owns their bytes.
"""
from __future__ import annotations

import os
import pickle

import torch.distributed as dist


class SpillStore:
    """Serialized page payloads keyed by spill-frame id."""

    def __init__(self, path: str | None = None):
        self.path = path
        self._mem: dict[int, bytes] = {}
        #: per-frame byte sizes (file flavor keeps them here too, so stats
        #: never have to stat() the directory)
        self._sizes: dict[int, int] = {}
        self.counters = {"writes": 0, "reads": 0,
                         "bytes_written": 0, "bytes_read": 0}
        if path is not None:
            if dist.is_initialized() and dist.get_world_size() > 1:
                path = self.path = os.path.join(path,
                                                f"rank{dist.get_rank()}")
            os.makedirs(path, exist_ok=True)

    # -- bytes movement --------------------------------------------------------
    def _file(self, frame: int) -> str:
        return os.path.join(self.path, f"frame_{frame}.bin")

    def put(self, frame: int, payload) -> int:
        """Serialize ``payload`` under ``frame``; returns bytes written.
        A frame already holding bytes rejects the write -- the allocator
        hands each spill frame to one owner at a time, so a collision is a
        lifecycle bug, not a legal overwrite."""
        if frame in self._sizes:
            raise ValueError(f"spill frame {frame} already holds a payload")
        blob = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
        if self.path is not None:
            with open(self._file(frame), "wb") as f:
                f.write(blob)
        else:
            self._mem[frame] = blob
        self._sizes[frame] = len(blob)
        self.counters["writes"] += 1
        self.counters["bytes_written"] += len(blob)
        return len(blob)

    def get(self, frame: int):
        """Deserialize the payload parked under ``frame`` (kept resident)."""
        if frame not in self._sizes:
            raise KeyError(f"no payload spilled under frame {frame}")
        if self.path is not None:
            with open(self._file(frame), "rb") as f:
                blob = f.read()
        else:
            blob = self._mem[frame]
        self.counters["reads"] += 1
        self.counters["bytes_read"] += len(blob)
        return pickle.loads(blob)

    def pop(self, frame: int):
        """``get`` + drop: the promotion path (SPILL -> HOST)."""
        payload = self.get(frame)
        self.drop(frame)
        return payload

    def drop(self, frame: int) -> None:
        """Discard ``frame``'s bytes (cancelled request, shutdown drain)."""
        if frame not in self._sizes:
            return
        if self.path is not None:
            try:
                os.remove(self._file(frame))
            except OSError:
                pass
        else:
            self._mem.pop(frame, None)
        del self._sizes[frame]

    # -- introspection ---------------------------------------------------------
    def __len__(self) -> int:
        return len(self._sizes)

    def __contains__(self, frame: int) -> bool:
        return frame in self._sizes

    def bytes_used(self) -> int:
        return sum(self._sizes.values())

    def stats(self) -> dict:
        return {"spilled_payloads": len(self._sizes),
                "spill_bytes": self.bytes_used(),
                "backing": "file" if self.path is not None else "bytes",
                **{f"spill_{k}": v for k, v in self.counters.items()}}

    def drain(self) -> int:
        """Drop every payload; returns the number dropped (shutdown)."""
        n = len(self._sizes)
        for frame in list(self._sizes):
            self.drop(frame)
        return n
