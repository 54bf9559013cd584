"""VM-walking paged-decode kernels: build, binding, wrappers.

The CUDA sources (``csrc/paged_decode.cu``) hold two kernels, the WRITE and
READ halves of the emulated-memory protocol.  Both walk the BlockManager's
``block_table`` inside the kernel, so logical page -> frame -> local row
translation rides the memory access instead of a host-side owner mask:

``paged_kv_write`` (K1)
    writes each sequence's new K/V row into slot ``(len-1) % page_slots``
    of frame ``block_table[b, (len-1) // page_slots]``, on the shard that
    owns the frame (``f % n_shards == sid``, local row ``f // n_shards``).
    Masked, length-0, unmapped and read-only (``frame_ro``) writes drop.
    Pages are updated IN PLACE.
``paged_gather_attend`` (K2)
    for each (sequence, local KV head) walks the block-table row over the
    pages this shard owns, attends the G grouped query heads to positions
    ``< len`` (and ``>= len - window``) with an online softmax, and returns
    UNNORMALISED ``(acc, m, l)`` in f32 for a log-sum-exp merge across
    shards.

``meta`` is ``(sid, n_shards, kv_start)``: the shard this call plays, the
number of shards frames are spread over, and the first KV head of ``q``.

A wrapper launches its kernel on the current stream (building the library
with ``nvcc`` at first use, :mod:`repro_torch.kernels.build`) and adds one
to ``LAUNCHES[name]``; any failure raises, and so do CPU tensors: a CUDA
kernel has no interpret mode.  The
plain versions the kernels are held against are
:func:`repro_torch.kernels.paged_decode.ref.write_kv` and
:func:`~repro_torch.kernels.paged_decode.ref.attend_shard`.
"""
from __future__ import annotations

from pathlib import Path

import torch

from repro_torch.kernels import build as _build

#: launches per kernel wrapper since the last :func:`reset_launch_counts`
LAUNCHES = {"paged_kv_write": 0, "paged_gather_attend": 0}

SOURCES = (Path(__file__).resolve().parent / "csrc" / "paged_decode.cu",)
LIBRARY = "paged_decode"


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build() -> tuple[Path, str]:
    """Build this library (see :func:`repro_torch.kernels.build.build`)."""
    return _build.build(LIBRARY, SOURCES)


def _bind(lib) -> None:
    import ctypes
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.paged_kv_write.argtypes = [p] * 8 + [i] * 10 + [p]
    lib.paged_kv_write.restype = i
    lib.paged_gather_attend.argtypes = ([p] * 8 + [i] * 12 + [f]
                                        + [i] * 2 + [p])
    lib.paged_gather_attend.restype = i


def _library():
    return _build.load(LIBRARY, SOURCES, _bind)


# -- argument checks ----------------------------------------------------------------

def _check_tables(block_table, lengths, b):
    if block_table.dtype != torch.int32 or block_table.dim() != 2 \
            or block_table.shape[0] != b:
        raise ValueError(f"block_table must be int32 [{b}, max_lpages], got "
                         f"{block_table.dtype} {tuple(block_table.shape)}")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (b,):
        raise ValueError(f"lengths must be int32 [{b}], got "
                         f"{lengths.dtype} {tuple(lengths.shape)}")


def _meta(meta) -> tuple[int, int, int]:
    sid, n_shards, kv_start = (int(x) for x in meta)
    if n_shards < 1 or not 0 <= sid < n_shards or kv_start < 0:
        raise ValueError(f"bad meta (sid, n_shards, kv_start) = {meta}")
    return sid, n_shards, kv_start


# -- K1: WRITE ----------------------------------------------------------------------

def paged_kv_write(k_new, v_new, k_pages, v_pages, block_table, lengths,
                   frame_ro, write_mask, meta):
    """K1.  k_new/v_new: [B, Hkv, D]; k/v_pages: [np_loc, slots, Hkv, D]
    (this shard's pages, updated in place); block_table: int32
    [B, max_lpages] GLOBAL frame ids; lengths: int32 [B] including the new
    token; frame_ro: bool [n_frames]; write_mask: bool [B]; meta:
    (sid, n_shards, kv_start).  Returns (k_pages, v_pages)."""
    dev = _build.check_cuda(k_new=k_new, v_new=v_new, k_pages=k_pages,
                      v_pages=v_pages, block_table=block_table,
                      lengths=lengths, frame_ro=frame_ro,
                      write_mask=write_mask)
    sid, n_shards, _ = _meta(meta)
    b, hkv, d = k_new.shape
    if v_new.shape != k_new.shape or v_new.dtype != k_new.dtype:
        raise ValueError("k_new and v_new must match in shape and dtype")
    if k_pages.dim() != 4 or tuple(k_pages.shape[2:]) != (hkv, d) \
            or v_pages.shape != k_pages.shape or v_pages.dtype != k_pages.dtype:
        raise ValueError(f"pages must be [np_loc, slots, {hkv}, {d}] and match, "
                         f"got {tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    _check_tables(block_table, lengths, b)
    if frame_ro.dtype != torch.bool or frame_ro.dim() != 1:
        raise ValueError("frame_ro must be bool [n_frames]")
    if write_mask.dtype != torch.bool or tuple(write_mask.shape) != (b,):
        raise ValueError(f"write_mask must be bool [{b}]")
    in_code = _build.dtype_code(k_new, "k_new")
    kv_code = _build.dtype_code(k_pages, "k_pages")
    if b == 0:
        return k_pages, v_pages
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.paged_kv_write(
            k_new.data_ptr(), v_new.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), block_table.data_ptr(), lengths.data_ptr(),
            frame_ro.data_ptr(), write_mask.data_ptr(), b,
            block_table.shape[1], k_pages.shape[1], k_pages.shape[0],
            frame_ro.shape[0], hkv * d, sid, n_shards, in_code, kv_code,
            _build.stream_of(dev))
    if err:
        raise RuntimeError(f"paged_kv_write launch failed: CUDA error {err}")
    LAUNCHES["paged_kv_write"] += 1
    return k_pages, v_pages


# -- K2: READ + attend ------------------------------------------------------------

def paged_gather_attend(q, k_pages, v_pages, block_table, lengths, meta, *,
                        scale=None, window=None):
    """K2.  q: [B, Hkv_loc, G, D] (whole KV-head groups); k/v_pages:
    [np_loc, slots, Hkv, D]; block_table: int32 [B, max_lpages] GLOBAL frame
    ids; meta: (sid, n_shards, kv_start) with kv_start the first KV head of
    q.  Returns UNNORMALISED (acc [B, Hkv_loc, G, D], m [B, Hkv_loc, G, 1],
    l [B, Hkv_loc, G, 1]), all f32."""
    dev = _build.check_cuda(q=q, k_pages=k_pages, v_pages=v_pages,
                      block_table=block_table, lengths=lengths)
    sid, n_shards, kv_start = _meta(meta)
    b, hkv_loc, g, d = q.shape
    if k_pages.dim() != 4 or k_pages.shape[3] != d \
            or v_pages.shape != k_pages.shape or v_pages.dtype != k_pages.dtype:
        raise ValueError(f"pages must be [np_loc, slots, Hkv, {d}] and match, "
                         f"got {tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    np_loc, slots, hkv = k_pages.shape[0], k_pages.shape[1], k_pages.shape[2]
    if kv_start + hkv_loc > hkv:
        raise ValueError(f"kv heads [{kv_start}, {kv_start + hkv_loc}) exceed "
                         f"the pages' {hkv}")
    _check_tables(block_table, lengths, b)
    q_code = _build.dtype_code(q, "q")
    kv_code = _build.dtype_code(k_pages, "k_pages")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    scale = d ** -0.5 if scale is None else float(scale)
    acc = torch.empty((b, hkv_loc, g, d), dtype=torch.float32, device=dev)
    m = torch.empty((b, hkv_loc, g, 1), dtype=torch.float32, device=dev)
    l = torch.empty((b, hkv_loc, g, 1), dtype=torch.float32, device=dev)
    if b == 0 or hkv_loc == 0:
        return acc, m, l
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.paged_gather_attend(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_table.data_ptr(), lengths.data_ptr(), acc.data_ptr(),
            m.data_ptr(), l.data_ptr(), b, hkv_loc, g, d, slots,
            block_table.shape[1], hkv, np_loc, sid, n_shards, kv_start,
            0 if window is None else int(window), scale, q_code, kv_code,
            _build.stream_of(dev))
    if err == _build.CUDA_ERROR_INVALID_VALUE:
        raise ValueError(
            f"paged_gather_attend refused D={d}, G={g} (CUDA error {err}): "
            "the kernel takes even head dims 2..256, groups whose per-warp "
            "softmax records fit 48 KB of shared memory and pointers "
            "aligned to an element pair (csrc/paged_decode.cu)")
    if err:
        raise RuntimeError(f"paged_gather_attend launch failed: CUDA error {err}")
    LAUNCHES["paged_gather_attend"] += 1
    return acc, m, l
