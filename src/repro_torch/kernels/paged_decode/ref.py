"""Composed-ops oracle for the paged-decode kernels (a port of
``repro.kernels.paged_decode.ref``).

One shard's worth of the paged decode step, written as plain torch over
host-style owner masks: :func:`write_target` (frame lookup + ``frame_ro``
write drop), :func:`owner_mask` (frame-membership test per physical page)
and a single-max softmax over every owned token.  This is the reference the
CUDA kernels are held against -- :func:`write_kv` is ``paged_kv_write``'s
plain version, :func:`qkv_write` ``paged_qkv_write``'s (the per-head RMS
norm and rotary of q and k, :func:`qk_rotate`, then :func:`write_kv`),
:func:`attend_shard` ``paged_gather_attend``'s -- and the path the CPU
runs.

All functions are per-shard: they see the local page arrays plus the
(replicated) VM tables and the shard's identity.  ``bt is None`` selects
the fixed arithmetic mapping (sequence ``b`` owns pages ``b*max_pages ..``)
used by the batch ``kv_layout``.
"""
from __future__ import annotations

import torch

from repro_torch.emem_vm.layout import shard_frames
from repro_torch.models import layers as L

NEG_INF = -1e30


def write_target(bt, fr, wm, pidx, b, max_pages):
    """Global frame each sequence writes this step, with drops applied.

    Returns (gpage [B], ok [B]): ``ok`` is False for masked-off sequences,
    unmapped pages and shared (read-only) frames.  ``pidx`` is -1 for a
    length-0 row and then reads the LAST column of ``bt`` (negative indices
    wrap, as in the reference)."""
    rows = torch.arange(b, device=pidx.device)
    if bt is not None:
        gpage = bt[rows, pidx]
        ro = fr[gpage.clamp(min=0)] & (gpage >= 0)
        ok = wm & (gpage >= 0) & ~ro
    else:
        gpage = rows * max_pages + pidx
        ok = wm
    return gpage, ok


def owner_mask(bt, fl, g_all, b, max_pages):
    """[B, n_local_pages] membership: does page g back sequence b?"""
    if bt is not None:
        lpage = fl[g_all]
        return bt[:, lpage] == g_all[None, :], lpage
    b_of, lpage = g_all // max_pages, g_all % max_pages
    return b_of[None, :] == torch.arange(b, device=g_all.device)[:, None], lpage


def partial_attend(q, k_pages, v_pages, lengths, *, owner, lpage,
                   head_start, group, window):
    """Partial attention of q against this shard's pages.

    q: [B, Hl, hd] (local heads); k/v_pages: [np_loc, slots, Hkv, hd];
    owner: [B, np_loc] -- whether each local page belongs to sequence b;
    lpage: [np_loc] logical in-sequence page of each local page.
    Returns (acc [B, Hl, hd] unnormalized, m [B, Hl], l [B, Hl]), f32."""
    b, hl, hd = q.shape
    np_loc, slots, hkv, _ = k_pages.shape
    dev = q.device
    scale = hd ** -0.5

    pos = lpage[:, None] * slots + torch.arange(slots, device=dev)
    tok_pos = pos.reshape(-1)                              # [T_loc]
    tok_owned = owner[:, :, None].expand(b, np_loc, slots).reshape(b, -1)

    kvh = (head_start + torch.arange(hl, device=dev)) // group   # [Hl]
    kf = k_pages.reshape(np_loc * slots, hkv, hd).float()
    vf = v_pages.reshape(np_loc * slots, hkv, hd).float()
    k_sel = kf[:, kvh]                                     # [T_loc, Hl, hd]
    v_sel = vf[:, kvh]

    logits = torch.einsum("bhd,thd->bht", q.float(), k_sel) * scale
    valid = tok_owned & (tok_pos[None, :] < lengths[:, None])   # [B, T_loc]
    if window is not None:
        valid &= tok_pos[None, :] >= (lengths[:, None] - window)
    logits = torch.where(valid[:, None, :], logits, NEG_INF)
    m = logits.amax(-1)                                    # [B, Hl]
    p = torch.exp(logits - m[..., None])
    p = torch.where(valid[:, None, :], p, 0.0)
    l = p.sum(-1)
    acc = torch.einsum("bht,thd->bhd", p, v_sel)
    return acc, m, l


def write_kv(k_new, v_new, k_pages, v_pages, lengths, bt, fr, wm, *, sid,
             n_shards, max_pages):
    """WRITE half (the plain version of the ``paged_kv_write`` kernel):
    scatter each sequence's new K/V row into its owning shard's page, IN
    PLACE.  Rows that do not write are masked out, never indexed with a
    sentinel; the rows are cast as the reference casts them
    (``L.cast_kv``: NaN past float8_e4m3fn's range).  Returns (k_pages,
    v_pages)."""
    b, slots = k_new.shape[0], k_pages.shape[1]
    pidx = torch.div(lengths - 1, slots, rounding_mode="floor")
    gpage, ok = write_target(bt, fr, wm, pidx, b, max_pages)
    sel = ok & (gpage % n_shards == sid)
    rows = torch.div(gpage, n_shards, rounding_mode="floor")
    off = (lengths - 1) % slots
    k_pages.index_put_((rows[sel], off[sel]), L.cast_kv(k_new[sel],
                                                        k_pages.dtype))
    v_pages.index_put_((rows[sel], off[sel]), L.cast_kv(v_new[sel],
                                                        v_pages.dtype))
    return k_pages, v_pages


def qk_rotate(q, k, lengths, *, q_norm=None, k_norm=None, eps=1e-6,
              rope_theta=None):
    """The plain version of ``kernel.qk_rotate``: ``L.qk_epilogue`` (the
    norm, then the rotary) of one decode token at position ``lengths - 1``.
    q: [B, Hq, D], k: [B, Hkv, D].  Returns (q, k) of those shapes."""
    q, k = L.qk_epilogue(q[:, :, None], k[:, :, None], (lengths - 1)[:, None],
                         q_norm=q_norm, k_norm=k_norm, eps=eps,
                         rope_theta=rope_theta)
    return q[:, :, 0], k[:, :, 0]


def qkv_write(q, k, v, k_pages, v_pages, lengths, bt, fr, wm, *, sid,
              n_shards, max_pages, q_norm=None, k_norm=None, eps=1e-6,
              rope_theta=None):
    """The plain version of ``kernel.paged_qkv_write``: :func:`qk_rotate`
    of the raw projections, then :func:`write_kv` of the rotated k and v.
    Pages are updated IN PLACE.  Returns the normed, rotated q."""
    q, k = qk_rotate(q, k, lengths, q_norm=q_norm, k_norm=k_norm, eps=eps,
                     rope_theta=rope_theta)
    write_kv(k, v, k_pages, v_pages, lengths, bt, fr, wm, sid=sid,
             n_shards=n_shards, max_pages=max_pages)
    return q


def attend_shard(q, k_pages, v_pages, lengths, bt, fl, *, sid, n_shards,
                 head_start, group, window, max_pages):
    """READ half (the plain version of the ``paged_gather_attend`` kernel):
    partial attention of q over the pages this shard owns.  Returns
    (acc [B, Hl, hd] unnormalized, m [B, Hl], l [B, Hl]), f32."""
    g_all = shard_frames(torch.arange(k_pages.shape[0], device=q.device),
                         sid, n_shards)
    owner, lpage = owner_mask(bt, fl, g_all, q.shape[0], max_pages)
    return partial_attend(q, k_pages, v_pages, lengths, owner=owner,
                          lpage=lpage, head_start=head_start, group=group,
                          window=window)


def paged_decode_shard(q, k_new, v_new, k_pages, v_pages, lengths, bt, fl,
                       fr, wm, *, sid, n_shards, head_start, group, window,
                       max_pages, use_vm, q_norm=None, k_norm=None, eps=1e-6,
                       rope_theta=None):
    """Composed per-shard decode step: :func:`qkv_write` (the q/k epilogue
    when norm weights or ``rope_theta`` are given, and the masked WRITE
    scatter) + partial attention over owned pages.  ``k_pages``/``v_pages``
    are updated IN PLACE (the reference returns new arrays) and returned.
    Returns (acc, m, l, k_pages, v_pages) with ``acc`` unnormalized so the
    caller can merge across shards."""
    bt_ = bt if use_vm else None
    fl_ = fl if use_vm else None
    q = qkv_write(q, k_new, v_new, k_pages, v_pages, lengths, bt_, fr, wm,
                  sid=sid, n_shards=n_shards, max_pages=max_pages,
                  q_norm=q_norm, k_norm=k_norm, eps=eps, rope_theta=rope_theta)
    acc, m, l = attend_shard(q, k_pages, v_pages, lengths, bt_, fl_, sid=sid,
                             n_shards=n_shards, head_start=head_start,
                             group=group, window=window, max_pages=max_pages)
    return acc, m, l, k_pages, v_pages
