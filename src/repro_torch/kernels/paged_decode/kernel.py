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
``paged_qkv_write`` (K1, the decode path's entry)
    the same launch taking q, k and v straight from the projections: the
    per-head RMS norm of q and k (``qk_norm``) and their rotary embedding
    at position ``len - 1``, then K1's write of the rotated k and of v;
    returns the normed, rotated q for K2.  :func:`qk_rotate` is the same
    launch with the page write off (the batch layout's q/k epilogue).
    Both count as K1 launches.
``paged_gather_attend`` (K2)
    for each (sequence, local KV head) walks the block-table row over the
    pages this shard owns, attends the G grouped query heads to positions
    ``< len`` (and ``>= len - window``) with an online softmax, and returns
    UNNORMALISED ``(acc, m, l)`` in f32 for a log-sum-exp merge across
    shards.  The walk is split into ``build.SPLIT``-long pieces of positions,
    one block each, merged in split order by the last block of a row in the
    same launch (the split walk it shares with K4,
    ``kernels/csrc/split_decode.cuh``): the wrapper passes scratch for the
    pieces' records (``torch.empty``) and a per-device buffer of counters,
    one per (sequence, KV head), that the kernel leaves at 0
    (:func:`repro_torch.kernels.build.counter_buffer`).

``meta`` is ``(sid, n_shards, kv_start)``: the shard this call plays, the
number of shards frames are spread over, and the first KV head of ``q``.

A wrapper launches its kernel on the current stream (building the library
with ``nvcc`` at first use, :mod:`repro_torch.kernels.build`) and adds one
to ``LAUNCHES[name]``; any failure raises, and so do CPU tensors: a CUDA
kernel has no interpret mode.  The
plain versions the kernels are held against are
:func:`repro_torch.kernels.paged_decode.ref.write_kv`,
:func:`~repro_torch.kernels.paged_decode.ref.qkv_write` (and its
``qk_rotate``) and :func:`~repro_torch.kernels.paged_decode.ref.attend_shard`.
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
    lib.paged_kv_write.argtypes = [p] * 8 + [i] * 11 + [p]
    lib.paged_kv_write.restype = i
    lib.paged_qkv_write.argtypes = [p] * 13 + [i] * 10 + [f, f] + [i] * 3 + [p]
    lib.paged_qkv_write.restype = i
    lib.paged_gather_attend.argtypes = ([p] * 10 + [i] * 12 + [f]
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


# -- K1: norm, rotary and WRITE ------------------------------------------------

def _check_write(k_new, v_new, k_pages, v_pages, block_table, lengths,
                 frame_ro, write_mask):
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
    return _build.dtype_code(k_pages, "k_pages")


def _raise_on(err, name, d):
    if err == _build.CUDA_ERROR_INVALID_VALUE:
        raise ValueError(f"{name} refused head_dim {d} (CUDA error {err}): the "
                         "kernel takes 1..2048, even with the rotary "
                         "(csrc/paged_decode.cu)")
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES["paged_kv_write"] += 1


def paged_kv_write(k_new, v_new, k_pages, v_pages, block_table, lengths,
                   frame_ro, write_mask, meta):
    """K1 as the TPU kernel has it.  k_new/v_new: [B, Hkv, D]; k/v_pages:
    [np_loc, slots, Hkv, D] (this shard's pages, updated in place);
    block_table: int32 [B, max_lpages] GLOBAL frame ids; lengths: int32 [B]
    including the new token; frame_ro: bool [n_frames]; write_mask: bool
    [B]; meta: (sid, n_shards, kv_start).  Returns (k_pages, v_pages)."""
    _build.check_no_grad("paged_kv_write", k_new=k_new, v_new=v_new)
    dev = _build.check_cuda(k_new=k_new, v_new=v_new, k_pages=k_pages,
                      v_pages=v_pages, block_table=block_table,
                      lengths=lengths, frame_ro=frame_ro,
                      write_mask=write_mask)
    sid, n_shards, _ = _meta(meta)
    kv_code = _check_write(k_new, v_new, k_pages, v_pages, block_table,
                           lengths, frame_ro, write_mask)
    in_code = _build.dtype_code(k_new, "k_new")
    b, hkv, d = k_new.shape
    if b == 0:
        return k_pages, v_pages
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.paged_kv_write(
            k_new.data_ptr(), v_new.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), block_table.data_ptr(), lengths.data_ptr(),
            frame_ro.data_ptr(), write_mask.data_ptr(), b, hkv, d,
            block_table.shape[1], k_pages.shape[1], k_pages.shape[0],
            frame_ro.shape[0], sid, n_shards, in_code, kv_code,
            _build.stream_of(dev))
    _raise_on(err, "paged_kv_write", d)
    return k_pages, v_pages


def _check_epilogue(q, k, lengths, q_norm, k_norm):
    """q [B, Hq, D] and k [B, Hkv, D] of one dtype; the norm weights [D] in
    it too, both or neither.  Returns the dtype code."""
    if q.dim() != 3 or k.dim() != 3 or q.shape[0] != k.shape[0] \
            or q.shape[2] != k.shape[2] or q.dtype != k.dtype:
        raise ValueError(f"q [B, Hq, D] and k [B, Hkv, D] must match in B, D "
                         f"and dtype, got {tuple(q.shape)} {q.dtype} / "
                         f"{tuple(k.shape)} {k.dtype}")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (q.shape[0],):
        raise ValueError(f"lengths must be int32 [{q.shape[0]}]")
    if (q_norm is None) != (k_norm is None):
        raise ValueError("q_norm and k_norm go together")
    for name, w in (("q_norm", q_norm), ("k_norm", k_norm)):
        if w is not None and (tuple(w.shape) != (q.shape[2],)
                              or w.dtype != q.dtype):
            raise ValueError(f"{name} must be [{q.shape[2]}] in {q.dtype}, got "
                             f"{tuple(w.shape)} {w.dtype}")
    return _build.dtype_code(q, "q")


def _qkv_launch(q, k, v, q_out, k_out, pages, lengths, q_norm, k_norm, eps,
                rope_theta, meta, in_code, kv_code, dev):
    kp, vp, bt, fr, wm = pages if pages is not None else (None,) * 5
    sid, n_shards, _ = _meta(meta)
    b, hq, d = q.shape
    if b == 0:
        return

    def ptr(t):
        return None if t is None else t.data_ptr()
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.paged_qkv_write(
            ptr(q), ptr(k), ptr(v), ptr(q_out), ptr(k_out), ptr(kp), ptr(vp),
            ptr(q_norm), ptr(k_norm), ptr(bt), ptr(lengths), ptr(fr), ptr(wm),
            b, hq, k.shape[1], d, 0 if bt is None else bt.shape[1],
            0 if kp is None else kp.shape[1], 0 if kp is None else kp.shape[0],
            0 if fr is None else fr.shape[0], sid, n_shards, float(eps),
            0.0 if rope_theta is None else float(rope_theta),
            int(rope_theta is not None), in_code, kv_code,
            _build.stream_of(dev))
    _raise_on(err, "paged_qkv_write", d)


def paged_qkv_write(q, k, v, k_pages, v_pages, block_table, lengths,
                    frame_ro, write_mask, meta, *, q_norm=None, k_norm=None,
                    eps=1e-6, rope_theta=None):
    """K1 on the decode path, one launch.  q: [B, Hq, D], k/v: [B, Hkv, D],
    the raw projections (after any bias) in the compute dtype, one block a
    head: Hq is the caller's query heads (a tensor-parallel rank's own)
    against every KV head its page replica takes; q_norm /
    k_norm: [D] RMS-norm weights in that dtype, or None (no ``qk_norm``);
    rope_theta: the rotary base, or None (no rotary); the rest as
    :func:`paged_kv_write`.  Norms and rotates q and k at position
    ``lengths - 1``, writes the rotated k and v as K1 does, and returns the
    normed, rotated q [B, Hq, D] in the compute dtype."""
    _build.check_no_grad("paged_qkv_write", q=q, k=k, v=v, q_norm=q_norm,
                         k_norm=k_norm)
    dev = _build.check_cuda(
        q=q, k=k, v=v, k_pages=k_pages, v_pages=v_pages,
        block_table=block_table, lengths=lengths, frame_ro=frame_ro,
        write_mask=write_mask,
        **{n: w for n, w in (("q_norm", q_norm), ("k_norm", k_norm))
           if w is not None})
    in_code = _check_epilogue(q, k, lengths, q_norm, k_norm)
    kv_code = _check_write(k, v, k_pages, v_pages, block_table, lengths,
                           frame_ro, write_mask)
    q_out = torch.empty_like(q)
    _qkv_launch(q, k, v, q_out, None,
                (k_pages, v_pages, block_table, frame_ro, write_mask),
                lengths, q_norm, k_norm, eps, rope_theta, meta, in_code,
                kv_code, dev)
    return q_out


def qk_rotate(q, k, lengths, *, q_norm=None, k_norm=None, eps=1e-6,
              rope_theta=None):
    """K1 with its page write off: the norm and rotary of
    :func:`paged_qkv_write` alone.  Returns (q, k) normed and rotated,
    [B, Hq, D] and [B, Hkv, D] in the compute dtype."""
    _build.check_no_grad("qk_rotate", q=q, k=k, q_norm=q_norm, k_norm=k_norm)
    dev = _build.check_cuda(
        q=q, k=k, lengths=lengths,
        **{n: w for n, w in (("q_norm", q_norm), ("k_norm", k_norm))
           if w is not None})
    in_code = _check_epilogue(q, k, lengths, q_norm, k_norm)
    q_out, k_out = torch.empty_like(q), torch.empty_like(k)
    _qkv_launch(q, k, None, q_out, k_out, None, lengths, q_norm, k_norm, eps,
                rope_theta, (0, 1, 0), in_code, in_code, dev)
    return q_out, k_out


# -- K2: READ + attend ------------------------------------------------------------

def paged_gather_attend(q, k_pages, v_pages, block_table, lengths, meta, *,
                        scale=None, window=None):
    """K2.  q: [B, Hkv_loc, G, D], the query heads of KV heads
    ``kv_start ..`` (whole KV-head groups, or with Hkv_loc 1 a tensor-parallel
    shard's G query heads inside one group); k/v_pages:
    [np_loc, slots, Hkv, D]; block_table: int32 [B, max_lpages] GLOBAL frame
    ids; meta: (sid, n_shards, kv_start) with kv_start the first KV head of
    q.  Returns UNNORMALISED (acc [B, Hkv_loc, G, D], m [B, Hkv_loc, G, 1],
    l [B, Hkv_loc, G, 1]), all f32."""
    _build.check_no_grad("paged_gather_attend", q=q, k_pages=k_pages,
                         v_pages=v_pages)
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
    max_lpages = block_table.shape[1]
    part = torch.empty((b, hkv_loc, _build.n_splits(max_lpages * slots), g,
                        d + 2),
                       dtype=torch.float32, device=dev)
    count = _build.counter_buffer(LIBRARY, dev, b * hkv_loc)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.paged_gather_attend(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_table.data_ptr(), lengths.data_ptr(), acc.data_ptr(),
            m.data_ptr(), l.data_ptr(), part.data_ptr(), count.data_ptr(), b,
            hkv_loc, g, d, slots, max_lpages, hkv, np_loc, sid, n_shards,
            kv_start, 0 if window is None else int(window), scale, q_code,
            kv_code, _build.stream_of(dev))
    if err == _build.CUDA_ERROR_INVALID_VALUE:
        raise ValueError(
            f"paged_gather_attend refused D={d}, G={g} (CUDA error {err}): "
            "the kernel takes even head dims 2..256 and pointers aligned to "
            "an element pair (csrc/paged_decode.cu)")
    if err:
        raise RuntimeError(f"paged_gather_attend launch failed: CUDA error {err}")
    LAUNCHES["paged_gather_attend"] += 1
    return acc, m, l
