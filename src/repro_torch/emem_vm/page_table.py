"""Batched logical->physical page translation for the emulated memory (a
port of ``repro.emem_vm.page_table``).

One page-table entry (PTE) per logical (virtual) page, packed into an int32:

    bits  0..23  physical frame index (16M frames max)
    bit   24     readable
    bit   25     writable
    bit   26     valid (mapped AND device-resident)
    bit   27     swapped (mapped but resident on HOST, not on device)

The entry array is laid out exactly like a small EMem -- ``[n_pt_pages,
pt_slots, 1]`` int32, padded to a whole number of pages -- so the table
itself has the shape of the memory it describes (:meth:`PageTable.emem_spec`).

Mutation (``map``/``unmap``/``protect``/``mark_swapped``/``restore``) is
control-plane and happens on a host (numpy) mirror; translation
(:func:`translate`) is the data-plane half, batched torch over a flat
entries tensor on the device.

Residency semantics: the valid bit means *device-resident*.  A swapped-out
page keeps its protection bits but drops valid and gains the swapped bit --
"invalid but mapped" -- so data-plane accesses are dropped exactly like an
unmapped page's would be, while the control plane
(:class:`repro_torch.emem_vm.vm.EMemVM`) can distinguish "never mapped"
(drop) from "on host" (fault the page back in, then retry the access).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import emem
from repro_torch.device import resolve_device

PROT_NONE = 0
PROT_R = 1
PROT_W = 2
PROT_RW = PROT_R | PROT_W

_FRAME_MASK = (1 << 24) - 1
_R_BIT = 1 << 24
_W_BIT = 1 << 25
_VALID_BIT = 1 << 26
_SWAPPED_BIT = 1 << 27


def pack_pte(frame: int, prot: int = PROT_RW, valid: bool = True,
             swapped: bool = False) -> int:
    pte = frame & _FRAME_MASK
    if prot & PROT_R:
        pte |= _R_BIT
    if prot & PROT_W:
        pte |= _W_BIT
    if valid:
        pte |= _VALID_BIT
    if swapped:
        pte |= _SWAPPED_BIT
    return pte


def translate(entries: torch.Tensor, addrs: torch.Tensor, page_slots: int):
    """Translate logical slot addresses through the PTE array.

    entries: flat int32 [n_vpages_padded]; addrs: [R] logical slots.
    Returns (phys_frame [R], offset [R], readable [R], writable [R]), the
    first two int64, where the permission masks are False for out-of-range
    or unmapped pages.
    """
    addrs = addrs.long()
    vpage = addrs // page_slots
    offset = addrs % page_slots
    in_range = (addrs >= 0) & (vpage < entries.shape[0])
    pte = entries[torch.where(in_range, vpage, 0)]
    valid = in_range & ((pte & _VALID_BIT) != 0)
    frame = (pte & _FRAME_MASK).long()
    readable = valid & ((pte & _R_BIT) != 0)
    writable = valid & ((pte & _W_BIT) != 0)
    return frame, offset, readable, writable


class PageTable:
    """Host-mutable, device-readable logical->physical page table."""

    def __init__(self, n_vpages: int, page_slots: int,
                 pt_page_slots: int = 128, n_shards: int = 1, device=None):
        self.n_vpages = n_vpages
        self.page_slots = page_slots          # slots per *data* page
        self.device = resolve_device(device)
        pad_to = pt_page_slots * n_shards
        padded = -(-n_vpages // pad_to) * pad_to
        self._spec = emem.EMemSpec(n_slots=padded, width=1,
                                   page_slots=pt_page_slots,
                                   n_shards=n_shards, dtype=torch.int32)
        self._host = np.zeros(padded, np.int32)
        self._device: torch.Tensor | None = None

    # -- EMem-style views -----------------------------------------------------
    @property
    def emem_spec(self) -> emem.EMemSpec:
        """Spec of the table's own storage (for sharding / analytics)."""
        return self._spec

    @property
    def entries(self) -> torch.Tensor:
        """Flat [n_vpages_padded] int32 device view (cached until mutated)."""
        if self._device is None:
            self._device = torch.tensor(self._host, device=self.device)
        return self._device

    def as_emem(self) -> torch.Tensor:
        """[n_pt_pages, pt_slots, 1] view matching :meth:`emem_spec`."""
        return self.entries.view(self._spec.global_shape())

    # -- control plane --------------------------------------------------------
    def _check(self, vpage: int) -> None:
        if not (0 <= vpage < self.n_vpages):
            raise ValueError(f"vpage {vpage} out of range")

    def map(self, vpage: int, frame: int, prot: int = PROT_RW) -> None:
        self._check(vpage)
        if self.is_mapped(vpage) or self.is_swapped(vpage):
            raise ValueError(f"vpage {vpage} already mapped")
        self._host[vpage] = pack_pte(frame, prot, valid=True)
        self._device = None

    def unmap(self, vpage: int) -> int:
        """Unmap and return the frame that was mapped there (-1 when the
        page was swapped out -- its contents live on host, not in a device
        frame; the caller owns dropping the host copy)."""
        self._check(vpage)
        if self.is_swapped(vpage):
            self._host[vpage] = 0
            self._device = None
            return -1
        if not self.is_mapped(vpage):
            raise ValueError(f"vpage {vpage} not mapped")
        frame = int(self._host[vpage]) & _FRAME_MASK
        self._host[vpage] = 0
        self._device = None
        return frame

    def protect(self, vpage: int, prot: int) -> None:
        self._check(vpage)
        if self.is_swapped(vpage):
            self._host[vpage] = pack_pte(0, prot, valid=False, swapped=True)
            self._device = None
            return
        if not self.is_mapped(vpage):
            raise ValueError(f"vpage {vpage} not mapped")
        frame = int(self._host[vpage]) & _FRAME_MASK
        self._host[vpage] = pack_pte(frame, prot, valid=True)
        self._device = None

    # -- residency (DEVICE <-> HOST) ------------------------------------------
    def mark_swapped(self, vpage: int) -> int:
        """DEVICE -> HOST: drop the valid bit, keep the protection bits, set
        the swapped bit.  Returns the device frame the page occupied (the
        caller frees it after saving the contents to the host store)."""
        self._check(vpage)
        if not self.is_mapped(vpage):
            raise ValueError(f"vpage {vpage} not mapped")
        pte = int(self._host[vpage])
        frame = pte & _FRAME_MASK
        prot = self.prot_of(vpage)
        self._host[vpage] = pack_pte(0, prot, valid=False, swapped=True)
        self._device = None
        return frame

    def restore(self, vpage: int, frame: int) -> None:
        """HOST -> DEVICE: remap a swapped-out page onto ``frame`` with its
        original protection bits."""
        self._check(vpage)
        if not self.is_swapped(vpage):
            raise ValueError(f"vpage {vpage} not swapped out")
        prot = self.prot_of(vpage)
        self._host[vpage] = pack_pte(frame, prot, valid=True)
        self._device = None

    # -- introspection --------------------------------------------------------
    def is_mapped(self, vpage: int) -> bool:
        return bool(self._host[vpage] & _VALID_BIT)

    def is_swapped(self, vpage: int) -> bool:
        return bool(self._host[vpage] & _SWAPPED_BIT)

    def prot_of(self, vpage: int) -> int:
        self._check(vpage)
        pte = int(self._host[vpage])
        return ((PROT_R if pte & _R_BIT else 0)
                | (PROT_W if pte & _W_BIT else 0))

    def frame_of(self, vpage: int) -> int:
        self._check(vpage)
        if not self.is_mapped(vpage):
            raise ValueError(f"vpage {vpage} not mapped")
        return int(self._host[vpage]) & _FRAME_MASK

    def mapped_count(self) -> int:
        return int((self._host & _VALID_BIT).astype(bool).sum())

    def swapped_count(self) -> int:
        return int((self._host & _SWAPPED_BIT).astype(bool).sum())
