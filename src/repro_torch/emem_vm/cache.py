"""Per-requester hot-page cache for the emulated memory (a port of
``repro.emem_vm.cache``).

A fixed-capacity, direct-mapped, write-back page cache: requester ``r`` keeps
``n_sets`` cache lines, each holding one physical frame's worth of slots
(``page_slots x width``) plus a tag (the frame id, -1 = empty) and a dirty
bit.  Frame ``f`` can only live in set ``f % n_sets`` -- so every shape below
is static; there is no LRU bookkeeping to serialize.

The state is a dict of tensors.  Where the reference's operations return a
new state, these update the tensors in place and return the same dict.  The
miss path is split into ``plan_fill`` (pick, per set, the line to install --
last miss in batch order wins) and ``apply_fill`` (install pages fetched by
the caller), because only the caller (:mod:`repro_torch.emem_vm.vm`) can
talk to the backing emulated memory.  Hit/miss counters live in the state.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.paged_decode.gather_ref import scatter_rows


@dataclasses.dataclass(frozen=True)
class CacheSpec:
    n_requesters: int
    n_sets: int
    page_slots: int
    width: int
    dtype: torch.dtype = torch.float32

    @property
    def capacity_slots(self) -> int:
        return self.n_sets * self.page_slots

    def set_of(self, frames: torch.Tensor) -> torch.Tensor:
        return frames % self.n_sets


class HotPageCache:
    """Namespace for the cache operations."""

    @staticmethod
    def create(spec: CacheSpec, device=None) -> dict:
        r, s = spec.n_requesters, spec.n_sets
        dev = resolve_device(device)
        return {
            "tag": torch.full((r, s), -1, dtype=torch.int32, device=dev),
            "data": torch.zeros((r, s, spec.page_slots, spec.width),
                                dtype=spec.dtype, device=dev),
            "dirty": torch.zeros((r, s), dtype=torch.bool, device=dev),
            "hits": torch.zeros((r,), dtype=torch.int32, device=dev),
            "misses": torch.zeros((r,), dtype=torch.int32, device=dev),
        }

    # -- read path ------------------------------------------------------------
    @staticmethod
    def lookup(spec: CacheSpec, state: dict, req: int, frames: torch.Tensor,
               offsets: torch.Tensor):
        """Probe lines for ``frames``; returns (vals [N, width], hit [N])."""
        sets = spec.set_of(frames)
        hit = state["tag"][req, sets] == frames
        vals = state["data"][req, sets, offsets]
        return vals, hit

    @staticmethod
    def count(spec: CacheSpec, state: dict, req: int, hit: torch.Tensor,
              active: torch.Tensor) -> dict:
        """Bump the hit/miss counters for the ``active`` lanes of a batch."""
        n_hit = (hit & active).sum().to(torch.int32)
        n_act = active.sum().to(torch.int32)
        state["hits"][req] += n_hit
        state["misses"][req] += n_act - n_hit
        return state

    # -- write path (write-back: hits never reach the backing memory) ---------
    @staticmethod
    def write_hits(spec: CacheSpec, state: dict, req: int,
                   frames: torch.Tensor, offsets: torch.Tensor,
                   values: torch.Tensor, mask: torch.Tensor) -> dict:
        """Scatter ``values`` into hit lines, marking them dirty; lanes off
        ``mask`` are dropped, and of several writes to one slot the last
        wins."""
        sets = spec.set_of(frames)
        lines = state["data"][req].view(-1, spec.width)
        scatter_rows(lines, torch.where(mask, sets * spec.page_slots + offsets,
                                        -1), values)
        touched = torch.zeros(spec.n_sets + 1, dtype=torch.bool,
                              device=sets.device)
        touched[torch.where(mask, sets, spec.n_sets)] = True
        state["dirty"][req] |= touched[:-1]
        return state

    # -- fill path ------------------------------------------------------------
    @staticmethod
    def plan_fill(spec: CacheSpec, frames: torch.Tensor,
                  miss: torch.Tensor) -> torch.Tensor:
        """Per set, the frame to install: the last missed lane mapping to it
        (batch order), or -1.  [N] -> [n_sets]."""
        n = frames.shape[0]
        sets = spec.set_of(frames).long()
        score = torch.where(miss, torch.arange(n, device=frames.device), -1)
        best = torch.full((spec.n_sets,), -1, dtype=torch.long,
                          device=frames.device)
        best.scatter_reduce_(0, sets, score, "amax")
        return torch.where(best >= 0, frames[best.clamp(min=0)], -1)

    @staticmethod
    def victims(spec: CacheSpec, state: dict, req: int, chosen: torch.Tensor):
        """Lines about to be evicted by ``chosen``: (frame [S], needs_wb [S],
        pages [S, page_slots, width]).  ``needs_wb`` is True only for valid
        dirty victims of sets that actually fill."""
        tag = state["tag"][req]
        needs_wb = (chosen >= 0) & (tag >= 0) & state["dirty"][req]
        return tag, needs_wb, state["data"][req]

    @staticmethod
    def apply_fill(spec: CacheSpec, state: dict, req: int,
                   chosen: torch.Tensor, pages: torch.Tensor) -> dict:
        """Install ``pages`` [n_sets, page_slots, width] into the chosen sets
        (lines with chosen == -1 keep their current contents), clean."""
        fill = chosen >= 0
        tag, data, dirty = (state[k][req] for k in ("tag", "data", "dirty"))
        tag.copy_(torch.where(fill, chosen, tag))
        data.copy_(torch.where(fill[:, None, None], pages.to(spec.dtype), data))
        dirty.masked_fill_(fill, False)
        return state

    # -- maintenance -----------------------------------------------------------
    @staticmethod
    def invalidate_frame(spec: CacheSpec, state: dict, frame: int) -> dict:
        """Drop (without write-back) every requester's line holding ``frame``.
        Used when the frame is freed -- its contents are dead."""
        match = state["tag"] == frame
        state["tag"].masked_fill_(match, -1)
        state["dirty"].masked_fill_(match, False)
        return state

    @staticmethod
    def dirty_lines(spec: CacheSpec, state: dict, req: int):
        """(frames [S], dirty [S], pages [S, page_slots, width]) for flush."""
        return (state["tag"][req], state["dirty"][req] & (state["tag"][req] >= 0),
                state["data"][req])

    @staticmethod
    def mark_clean(spec: CacheSpec, state: dict, req: int) -> dict:
        state["dirty"][req] = False
        return state

    @staticmethod
    def hit_rate(state: dict) -> float:
        h = float(state["hits"].sum())
        m = float(state["misses"].sum())
        return h / max(h + m, 1.0)
