"""Plain PyTorch versions of the emulated-memory gathers (K6, K7) and the
slot scatter (a port of ``repro.kernels.paged_decode.gather_ref``).

They are the CPU path and what the CUDA kernels (:mod:`.gather`) are held
against.  Indices follow the reference oracle: a negative slot or page id
reads zeros, and one past the end reads the last row, as JAX clamps
``flat[idx]``.  Scatters drop negative and out-of-range slots, as JAX's
``mode="drop"`` does, and where one batch writes a slot more than once the
last write wins, as the reference's in-order CPU scatter does; torch's
``index_put_`` on CUDA picks an arbitrary writer among duplicates, so the
batch is first reduced to its last writer per slot.  Scatters update the
store in place.
"""
from __future__ import annotations

import torch


def gather_slots(pages: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """pages: [n_pages, page_slots, width]; slots: [q] flat slot indices
    (slot = page * page_slots + offset), negative for "empty" (zeros).
    Returns [q, width]."""
    n_pages, page_slots, width = pages.shape
    flat = pages.reshape(n_pages * page_slots, width)
    safe = slots.long().clamp(0, flat.shape[0] - 1)
    out = flat.index_select(0, safe)
    return out.masked_fill((slots < 0)[:, None], 0)


def gather_pages(pages: torch.Tensor, page_ids: torch.Tensor) -> torch.Tensor:
    """Whole pages (the paper's DMA block transfer).  pages: [n_pages,
    page_slots, width]; page_ids: [p], negative for "empty" (a zero page).
    Returns [p, page_slots, width]."""
    safe = page_ids.long().clamp(0, pages.shape[0] - 1)
    out = pages.index_select(0, safe)
    return out.masked_fill((page_ids < 0)[:, None, None], 0)


def last_writers(idx: torch.Tensor) -> torch.Tensor:
    """Mask of the entries of ``idx`` [n] that are the last occurrence of
    their value, so that scattering only those applies the batch in order."""
    if idx.numel() == 0:
        return torch.zeros_like(idx, dtype=torch.bool)
    sorted_idx, order = torch.sort(idx, stable=True)
    last = torch.ones_like(sorted_idx, dtype=torch.bool)
    last[:-1] = sorted_idx[1:] != sorted_idx[:-1]
    keep = torch.empty_like(last)
    keep[order] = last
    return keep


def scatter_rows(flat: torch.Tensor, idx: torch.Tensor,
                 values: torch.Tensor) -> torch.Tensor:
    """``flat[idx] = values`` in batch order, in place: indices outside
    ``[0, len(flat))`` are dropped, and of several writes to one row the
    last wins.  Returns ``flat``."""
    idx = idx.long()
    keep = (idx >= 0) & (idx < flat.shape[0])
    keep &= last_writers(torch.where(keep, idx, -1))
    flat[idx[keep]] = values[keep].to(flat.dtype)
    return flat


def scatter_slots(pages: torch.Tensor, slots: torch.Tensor,
                  values: torch.Tensor) -> torch.Tensor:
    """Scatter rows into the paged store in place; negative and
    out-of-range slots are dropped.  Returns ``pages``."""
    n_pages, page_slots, width = pages.shape
    scatter_rows(pages.view(n_pages * page_slots, width), slots, values)
    return pages
