"""Public gathers and scatter of the emulated memory's paged store (a port
of ``repro.kernels.paged_decode.gather_ops``).

The reference's rule is ``use_pallas=_on_tpu()``; here the card takes the
TPU's place: a store on the card goes through the CUDA kernels K7 and K6
(:mod:`.gather`), a store on the CPU through their plain versions
(:mod:`.gather_ref`).  There is no fallback between the two.  The
reference pads ``width`` to the TPU's 128 lanes; the kernels here copy rows
of any byte size, so nothing is padded.  The scatter has no kernel in the
reference either and stays plain torch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_decode import gather as _k
from repro_torch.kernels.paged_decode import gather_ref as _ref

scatter_slots = _ref.scatter_slots


def gather_slots(pages: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Gather slot rows from a paged store: [q] -> [q, width]."""
    if pages.device.type != "cuda":
        return _ref.gather_slots(pages, slots)
    return _k.gather_slots(pages, slots.to(torch.int32).contiguous())


def gather_pages(pages: torch.Tensor, page_ids: torch.Tensor) -> torch.Tensor:
    """Gather whole pages: [p] -> [p, page_slots, width]."""
    if pages.device.type != "cuda":
        return _ref.gather_pages(pages, page_ids)
    return _k.gather_pages(pages, page_ids.to(torch.int32).contiguous())
