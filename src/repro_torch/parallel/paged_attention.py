"""Paged decode attention over the emulated KV memory (a port of
``repro.parallel.paged_attention``).

THIN DISPATCH layer: the per-shard compute lives in
:mod:`repro_torch.kernels.paged_decode` (the VM-walking CUDA kernels and the
composed oracle, selected by ``resolve_impl`` from
``ModelConfig.paged_kernel`` and the tensors' device).  This module adds
what is control-plane:

  * without a mesh context, the single-device call (``sid=0,
    n_shards=1``) and the normalisation of its unnormalised partials, plus
    :func:`merge_shard_partials`, the log-sum-exp merge of several shards'
    partials (one card emulates a multi-shard layout by calling the
    per-shard step once per ``sid``);
  * with a context installed (:mod:`repro_torch.parallel.mesh_ctx`), at
    any world size, one, the reference's ``shard_map`` body on this rank:
    the KV pages are cyclically owned by the ranks of ``kv_axes`` (frame
    ``f`` on kv index ``f % S`` at local row ``f // S``,
    :mod:`repro_torch.emem_vm.layout`) and replicated over the
    tensor-parallel axis, so every tp rank writes all KV heads into its
    replica; query heads are split over ``tp_axis``; the partials are
    merged with ``all_reduce`` MAX of ``m`` and SUM of ``acc * w`` and
    ``l * w`` (one call) over the kv group, and the head blocks gathered
    over tp.  In the tensor-parallel split form
    (:meth:`repro_torch.models.model.Model.shard`) q arrives as the rank's
    own heads and leaves as them, for its rows of ``wo``: no head is
    sliced or gathered, but the rank's k/v heads are gathered over tp so
    that its replica of the pages takes every KV head's new row;
  * the host-side page movers (swap, COW) the serving engine hands the
    BlockManager as ``PageIO`` callbacks, rank-aware under a context (the
    owner reads a frame and every rank gets the payload; a rank writes
    only the frames it owns), and the per-slot state movers that carry a
    swapped sequence's recurrent (Mamba2) state.

Frame ownership is the ``vm`` translation state exported by the serving
engine's BlockManager (``cache["vm"]``): ``block_table`` [B, max_lpages]
(logical page -> frame, -1 unmapped; a frame may appear in several rows
under prefix sharing), ``frame_lpage`` [n_frames] (the logical page a frame
holds) and ``frame_ro`` [n_frames] (shared, so writes to it are dropped).
Without ``vm`` the mapping is the fixed arithmetic layout (sequence ``b``
owns pages ``b*max_pages ..``).

Pages are updated in place: ``k_pages``/``v_pages`` are ``[n_periods,
n_pages, slots, Hkv, hd]`` tensors (``n_pages / S`` of them on a rank
under a context) and every per-layer slice is a contiguous view, so the
kernels' writes land in the cache's storage.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.emem_vm.layout import frame_rows
from repro_torch.kernels.paged_decode import ops as pd_ops
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import mesh_ctx


def paged_decode_attention(cfg: ModelConfig, q, k_new, v_new, k_pages,
                           v_pages, lengths, vm: dict | None = None,
                           write_mask=None, *, epilogue: dict):
    """q: [B, H, hd]; k_new/v_new: [B, Hkv, hd], the raw projections, which
    the shard step norms and rotates at position len-1 as ``epilogue``
    (:func:`repro_torch.models.layers.qk_epilogue_args`) says before the
    write; k/v_pages: [n_pages, slots, Hkv, hd].  Returns (out, k_pages,
    v_pages) with the pages updated in place.  Under a mesh context the
    pages are this rank's block and the step is the rank body.

    ``write_mask`` [B] suppresses the K/V write for masked-off sequences
    (the engine prefills one slot through the whole decode batch)."""
    ctx = mesh_ctx.get_context()
    b, h, hd = q.shape
    split = h < cfg.n_heads
    if split:
        if ctx is None:
            raise RuntimeError("a rank's shard of the heads needs the mesh "
                               "context it was split over")
        if k_new.shape[1] < cfg.n_kv_heads:
            k_new, v_new = _every_kv_head(cfg, k_new, v_new, ctx.tp)
    n_shards = 1 if ctx is None else ctx.n_kv_shards
    max_pages = k_pages.shape[0] * n_shards // b
    group = cfg.n_heads // cfg.n_kv_heads
    if write_mask is None:
        write_mask = torch.ones((b,), dtype=torch.bool, device=q.device)
    if vm is None:
        bt = fl = fr = None
    else:
        bt, fl, fr = vm["block_table"], vm["frame_lpage"], vm["frame_ro"]
    if ctx is None:
        impl = pd_ops.resolve_impl(cfg.paged_kernel, h, group, q.device)
        acc, m, l, kp, vp = pd_ops.paged_decode_shard(
            q, k_new, v_new, k_pages, v_pages, lengths, bt, fl, fr,
            write_mask, sid=0, n_shards=1, head_start=0, group=group,
            window=cfg.window, max_pages=max_pages, use_vm=vm is not None,
            impl=impl, **epilogue)
        out = (acc / torch.where(l == 0.0, 1.0, l)[..., None]).to(q.dtype)
        return out, kp, vp

    if split:
        hl = h
    elif h % ctx.tp:
        raise ValueError(f"{h} query heads do not split over tp = {ctx.tp}")
    else:
        hl = h // ctx.tp
    head_start = ctx.tp_index * hl
    impl = pd_ops.resolve_impl(cfg.paged_kernel, hl, group, q.device)
    if not split:
        q = q[:, head_start:head_start + hl]
    acc, m, l, kp, vp = pd_ops.paged_decode_shard(
        q.contiguous(), k_new, v_new, k_pages,
        v_pages, lengths, bt, fl, fr, write_mask, sid=ctx.kv_index,
        n_shards=n_shards, head_start=head_start, group=group,
        window=cfg.window, max_pages=max_pages, use_vm=vm is not None,
        impl=impl, **epilogue)
    # merge the partials across the emulated-memory shards: the max, then
    # acc * w and l * w summed in one call
    m_glob = mesh_ctx.all_reduce(m.clone(), "max", ctx.kv_group)
    w = torch.exp(m - m_glob)
    sums = mesh_ctx.all_reduce(
        torch.cat([acc * w[..., None], (l * w)[..., None]], -1), "sum",
        ctx.kv_group)
    num, den = sums[..., :-1], sums[..., -1]
    out = (num / torch.where(den == 0.0, 1.0, den)[..., None]).to(q.dtype)
    if split:
        return out, kp, vp
    heads = mesh_ctx.all_gather(out, ctx.tp_group)      # [tp, B, hl, hd]
    return heads.transpose(0, 1).reshape(b, h, hd), kp, vp


def _every_kv_head(cfg: ModelConfig, k_new, v_new, tp: int):
    """Every KV head's new row from the tp ranks' shards [B, Hkv_loc, hd]
    (one gather of k and v): the first rank of each block of ranks that
    holds the same KV heads (``tp / Hkv`` of them where tp > Hkv) gives
    them.  Returns k_new, v_new [B, Hkv, hd]."""
    b, hkv_loc, hd = k_new.shape
    blocks = cfg.n_kv_heads // hkv_loc
    kv = mesh_ctx.tp_gather(torch.cat([k_new, v_new], 1))[::tp // blocks]
    kv = kv.permute(1, 0, 2, 3).reshape(b, blocks, 2, hkv_loc, hd)
    return (kv[:, :, 0].reshape(b, cfg.n_kv_heads, hd),
            kv[:, :, 1].reshape(b, cfg.n_kv_heads, hd))


def merge_shard_partials(accs, ms, ls):
    """Log-sum-exp merge of per-shard partials: ``accs`` [S, ..., hd],
    ``ms``/``ls`` [S, ...] -> the normalised output [..., hd] (f32), with
    the ``l == 0`` guard for rows no shard attended."""
    m_glob = ms.amax(0)
    w = torch.exp(ms - m_glob)
    num = (accs * w[..., None]).sum(0)
    den = (ls * w).sum(0)
    return num / torch.where(den == 0.0, 1.0, den)[..., None]


def paged_decode_block(cfg: ModelConfig, p_attn, h, entry: dict, lengths,
                       vm: dict | None = None, write_mask=None):
    """Attention sub-block for decode with the paged/pooled KV layout.

    h: [B, 1, d] (already normed).  The q/k norm and rotary run inside the
    shard step (on CUDA tensors in K1's launch).  Returns (out [B, 1, d],
    entry) -- the entry's pages are updated in place."""
    b, hd = h.shape[0], cfg.hd
    q, k_new, v_new = L.qkv_projections(cfg, p_attn, h)
    out, kp, vp = paged_decode_attention(
        cfg, q.view(b, -1, hd), k_new.view(b, -1, hd), v_new.view(b, -1, hd),
        entry["k_pages"], entry["v_pages"], lengths, vm, write_mask,
        epilogue=L.qk_epilogue_args(cfg, p_attn))
    out = L.attention_out(cfg, p_attn, out.reshape(b, 1, -1))
    return out, {"k_pages": kp, "v_pages": vp}


def paged_entries(cache: dict):
    """(key, entry) pairs of the cache holding paged KV pages -- what the
    swap/COW page movers touch."""
    for key, entry in cache.items():
        if key.startswith("b") and isinstance(entry, dict) \
                and "k_pages" in entry:
            yield key, entry


def slot_state_entries(cache: dict):
    """(key, entry) pairs holding per-SLOT state (the batch layout's k/v,
    Mamba2 conv/ssd rows) rather than shared paged KV -- what a slot reset
    zeroes and a swap record carries."""
    for key, entry in cache.items():
        if key.startswith("b") and isinstance(entry, dict) \
                and "k_pages" not in entry:
            yield key, entry


#: numpy has no bfloat16/fp8: such pages travel to the host as raw bits
_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32}
_NUMPY_NATIVE = (torch.float32, torch.float64, torch.float16)


def to_host(t: torch.Tensor) -> np.ndarray:
    """Copy a device tensor to a fresh host numpy array (raw bits for the
    dtypes numpy cannot hold)."""
    if t.dtype not in _NUMPY_NATIVE:
        t = t.view(_BITS[t.element_size()])
    return t.cpu().numpy().copy()


def from_host(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """Inverse of :func:`to_host`: a device tensor of ``dtype``."""
    t = torch.tensor(a, device=device)
    return t if dtype in _NUMPY_NATIVE else t.view(dtype)


def read_slot_state(cache: dict, slot: int) -> dict:
    """Snapshot a slot's per-slot cache rows (DEVICE -> HOST), so a
    swapped-out sequence resumes without replaying its recurrent state:
    ``{key: {name: host rows [n_periods, ...]}}`` (the reference engine's
    ``_slot_state_read``)."""
    return {key: {name: to_host(t[:, slot]) for name, t in entry.items()}
            for key, entry in slot_state_entries(cache)}


def write_slot_state(cache: dict, slot: int, state: dict) -> None:
    """Write a :func:`read_slot_state` snapshot back into ``slot``'s rows,
    in place (the reference engine's ``_slot_state_write``)."""
    for key, sub in state.items():
        for name, rows in sub.items():
            t = cache[key][name]
            t[:, slot] = from_host(rows, t.dtype, t.device)


def _placed(frames, n_local: int):
    """(kv index owning each frame, its local row), through the layout's
    :func:`~repro_torch.emem_vm.layout.frame_rows`: frame ``f`` is row
    ``owner * n_local + local`` of the ranks' concatenated pages.  Without
    a context every frame is kv index 0's, at row ``f``."""
    ctx = mesh_ctx.get_context()
    s = 1 if ctx is None else ctx.n_kv_shards
    rows = frame_rows(frames, n_local * s, s)
    return rows // n_local, rows % n_local


def _frame_pages(pages: torch.Tensor, frames: list) -> torch.Tensor:
    """The frames' rows [n_periods, n, ...] of a pages tensor, as their
    owners hold them and the same on every rank: under a context each rank
    reads the frames it owns and the kv group gathers them."""
    f = torch.tensor(frames, dtype=torch.long, device=pages.device)
    owner, local = _placed(f, pages.shape[1])
    ctx = mesh_ctx.get_context()
    if ctx is None:
        return pages[:, local]
    mine = pages[:, torch.where(owner == ctx.kv_index, local, 0)]
    every = mesh_ctx.all_gather(mine, ctx.kv_group)   # [S, n_periods, n, ...]
    return every.transpose(1, 2)[owner, torch.arange(len(frames),
                                                     device=f.device)
                                 ].transpose(0, 1)


def _owned(frames: list, n_local: int) -> tuple[list[int], torch.Tensor]:
    """(indices into ``frames`` of the frames this rank owns, their local
    rows)."""
    ctx = mesh_ctx.get_context()
    owner, local = _placed(np.asarray(frames, np.int64), n_local)
    sel = np.flatnonzero(owner == (0 if ctx is None else ctx.kv_index))
    return sel.tolist(), torch.tensor(local[sel], dtype=torch.long)


def read_frame_pages(cache: dict, frames) -> list:
    """Snapshot physical frames off the device (DEVICE -> HOST): one opaque
    payload per frame, ``{layer_key: (k_rows, v_rows)}`` as host numpy,
    the same on every rank.  One gather + one transfer per layer key, not
    per frame."""
    frames = list(frames)
    payloads = [dict() for _ in frames]
    for key, entry in paged_entries(cache):
        k = to_host(_frame_pages(entry["k_pages"], frames))  # [n_periods, n, ..]
        v = to_host(_frame_pages(entry["v_pages"], frames))
        for i in range(len(frames)):
            payloads[i][key] = (k[:, i], v[:, i])
    return payloads


def write_frame_pages(cache: dict, assignments) -> dict:
    """Write swapped-out payloads back into device frames (HOST -> DEVICE),
    in place: ``assignments`` is ``[(frame, payload), ...]`` with payloads
    from :func:`read_frame_pages`; under a context a rank writes only the
    frames it owns.  One scatter per layer key."""
    for key, entry in paged_entries(cache):
        kp, vp = entry["k_pages"], entry["v_pages"]
        sel, rows = _owned([f for f, _ in assignments], kp.shape[1])
        if not sel:
            return cache
        k_rows = np.stack([assignments[i][1][key][0] for i in sel], axis=1)
        v_rows = np.stack([assignments[i][1][key][1] for i in sel], axis=1)
        kp[:, rows.to(kp.device)] = from_host(k_rows, kp.dtype, kp.device)
        vp[:, rows.to(vp.device)] = from_host(v_rows, vp.dtype, vp.device)
    return cache


def cow_copy_pages(cache: dict, copies) -> dict:
    """Apply BlockManager CowCopy records to every attention layer's pages,
    in place (device-side row copies, outside the decode step).  Under a
    context the source and destination frames may live on different
    ranks: the sources' rows reach every rank, and each writes the
    destinations it owns."""
    if not copies:
        return cache
    for key, entry in paged_entries(cache):
        for name in ("k_pages", "v_pages"):
            pages = entry[name]
            sel, dst = _owned([c.dst for c in copies], pages.shape[1])
            src = _frame_pages(pages, [c.src for c in copies])
            if sel:
                pages[:, dst.to(pages.device)] = src[:, sel]
    return cache
