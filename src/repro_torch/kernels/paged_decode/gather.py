"""K7 ``gather_slots`` and K6 ``gather_pages``: the hand-written CUDA
gathers of the emulated memory -- build, binding, wrappers.

``csrc/gather.cu`` holds both kernels (its header comment gives the design
and the bound).  They copy bytes, so they take a store of any dtype.  A
wrapper launches its kernel on the current stream, building the library
with ``nvcc`` at first use (:mod:`repro_torch.kernels.build`), and adds one
to ``LAUNCHES[name]``; any failure raises, and so do CPU tensors: a CUDA
kernel has no interpret mode.  Their plain versions are
:func:`repro_torch.kernels.paged_decode.gather_ref.gather_slots` and
:func:`~repro_torch.kernels.paged_decode.gather_ref.gather_pages`.
"""
from __future__ import annotations

from pathlib import Path

import torch

from repro_torch.kernels import build as _build

#: launches per kernel wrapper since the last :func:`reset_launch_counts`
LAUNCHES = {"gather_slots": 0, "gather_pages": 0}

SOURCES = (Path(__file__).resolve().parent / "csrc" / "gather.cu",)
LIBRARY = "gather"


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build() -> tuple[Path, str]:
    """Build this library (see :func:`repro_torch.kernels.build.build`)."""
    return _build.build(LIBRARY, SOURCES)


def _bind(lib) -> None:
    import ctypes
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for entry in (lib.gather_slots, lib.gather_pages):
        entry.argtypes = [p] * 3 + [ll] * 3 + [p]
        entry.restype = i


def _check(pages, index, what):
    dev = _build.check_cuda(pages=pages, **{what: index})
    if pages.dim() != 3:
        raise ValueError(f"pages must be [n_pages, page_slots, width], got "
                         f"{tuple(pages.shape)}")
    if index.dtype != torch.int32 or index.dim() != 1:
        raise ValueError(f"{what} must be int32 [n], got {index.dtype} "
                         f"{tuple(index.shape)}")
    if pages.numel() == 0:
        raise ValueError("pages must not be empty")
    return dev


def _launch(name, dev, pages, index, out, n_rows, row_bytes):
    if index.numel() == 0:
        return out
    lib = _build.load(LIBRARY, SOURCES, _bind)
    with torch.cuda.device(dev):
        err = getattr(lib, name)(pages.data_ptr(), index.data_ptr(),
                                 out.data_ptr(), n_rows, index.numel(),
                                 row_bytes, _build.stream_of(dev))
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    return out


def gather_slots(pages: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """K7.  pages: [n_pages, page_slots, width]; slots: int32 [q] (slot
    ``s`` is row ``s % page_slots`` of page ``s // page_slots``; negative
    gives zeros, past the end the last slot).  Returns [q, width]."""
    dev = _check(pages, slots, "slots")
    n_pages, page_slots, width = pages.shape
    out = torch.empty((slots.shape[0], width), dtype=pages.dtype, device=dev)
    return _launch("gather_slots", dev, pages, slots, out,
                   n_pages * page_slots, width * pages.element_size())


def gather_pages(pages: torch.Tensor, page_ids: torch.Tensor) -> torch.Tensor:
    """K6.  pages: [n_pages, page_slots, width]; page_ids: int32 [p]
    (negative gives a zero page, past the end the last page).  Returns
    [p, page_slots, width]."""
    dev = _check(pages, page_ids, "page_ids")
    n_pages, page_slots, width = pages.shape
    out = torch.empty((page_ids.shape[0], page_slots, width),
                      dtype=pages.dtype, device=dev)
    return _launch("gather_pages", dev, pages, page_ids, out, n_pages,
                   page_slots * width * pages.element_size())
