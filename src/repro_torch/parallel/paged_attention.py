"""Paged decode attention over the emulated KV memory (a port of
``repro.parallel.paged_attention``, single-device path).

THIN DISPATCH layer: the per-shard compute lives in
:mod:`repro_torch.kernels.paged_decode` (the VM-walking CUDA kernels and the
composed oracle, selected by ``resolve_impl`` from
``ModelConfig.paged_kernel`` and the tensors' device).  This module adds
what is control-plane:

  * the single-device call (``sid=0, n_shards=1``) and the normalisation of
    its unnormalised partials, plus :func:`merge_shard_partials`, the
    log-sum-exp merge of several shards' partials (the reference's
    cross-shard merge; one card emulates a multi-shard layout by calling
    the per-shard step once per ``sid``);
  * the host-side page movers (swap, COW) the serving engine hands the
    BlockManager as ``PageIO`` callbacks, and the per-slot state movers
    that carry a swapped sequence's recurrent (Mamba2) state.

Frame ownership is the ``vm`` translation state exported by the serving
engine's BlockManager (``cache["vm"]``): ``block_table`` [B, max_lpages]
(logical page -> frame, -1 unmapped; a frame may appear in several rows
under prefix sharing), ``frame_lpage`` [n_frames] (the logical page a frame
holds) and ``frame_ro`` [n_frames] (shared, so writes to it are dropped).
Without ``vm`` the mapping is the fixed arithmetic layout (sequence ``b``
owns pages ``b*max_pages ..``).

Pages are updated in place: ``k_pages``/``v_pages`` are ``[n_periods,
n_pages, slots, Hkv, hd]`` tensors and every per-layer slice is a
contiguous view, so the kernels' writes land in the cache's storage.
The multi-device shard_map path waits for the sharding slice.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.paged_decode import ops as pd_ops
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def paged_decode_attention(cfg: ModelConfig, q, k_new, v_new, k_pages,
                           v_pages, lengths, vm: dict | None = None,
                           write_mask=None, *, epilogue: dict):
    """q: [B, H, hd]; k_new/v_new: [B, Hkv, hd], the raw projections, which
    the shard step norms and rotates at position len-1 as ``epilogue``
    (:func:`repro_torch.models.layers.qk_epilogue_args`) says before the
    write; k/v_pages: [n_pages, slots, Hkv, hd].  Returns (out, k_pages,
    v_pages) with the pages updated in place.

    ``write_mask`` [B] suppresses the K/V write for masked-off sequences
    (the engine prefills one slot through the whole decode batch)."""
    b, h, hd = q.shape
    max_pages = k_pages.shape[0] // b
    group = cfg.n_heads // cfg.n_kv_heads
    if write_mask is None:
        write_mask = torch.ones((b,), dtype=torch.bool, device=q.device)
    if vm is None:
        bt = fl = fr = None
    else:
        bt, fl, fr = vm["block_table"], vm["frame_lpage"], vm["frame_ro"]
    impl = pd_ops.resolve_impl(cfg.paged_kernel, h, group, q.device)
    acc, m, l, kp, vp = pd_ops.paged_decode_shard(
        q, k_new, v_new, k_pages, v_pages, lengths, bt, fl, fr, write_mask,
        sid=0, n_shards=1, head_start=0, group=group, window=cfg.window,
        max_pages=max_pages, use_vm=vm is not None, impl=impl, **epilogue)
    out = (acc / torch.where(l == 0.0, 1.0, l)[..., None]).to(q.dtype)
    return out, kp, vp


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
        cfg, q.view(b, cfg.n_heads, hd), k_new.view(b, cfg.n_kv_heads, hd),
        v_new.view(b, cfg.n_kv_heads, hd), entry["k_pages"],
        entry["v_pages"], lengths, vm, write_mask,
        epilogue=L.qk_epilogue_args(cfg, p_attn))
    out = out.reshape(b, 1, cfg.n_heads * cfg.hd) @ p_attn["wo"]
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


def _rows(frames, device) -> torch.Tensor:
    # one shard: frame f is row f of the pages array
    return torch.tensor(list(frames), dtype=torch.long, device=device)


def read_frame_pages(cache: dict, frames) -> list:
    """Snapshot physical frames off the device (DEVICE -> HOST): one opaque
    payload per frame, ``{layer_key: (k_rows, v_rows)}`` as host numpy.
    One gather + one transfer per layer key, not per frame."""
    frames = list(frames)
    payloads = [dict() for _ in frames]
    for key, entry in paged_entries(cache):
        rows = _rows(frames, entry["k_pages"].device)
        k = to_host(entry["k_pages"][:, rows])      # [n_periods, n, slots, ...]
        v = to_host(entry["v_pages"][:, rows])
        for i in range(len(frames)):
            payloads[i][key] = (k[:, i], v[:, i])
    return payloads


def write_frame_pages(cache: dict, assignments) -> dict:
    """Write swapped-out payloads back into device frames (HOST -> DEVICE),
    in place: ``assignments`` is ``[(frame, payload), ...]`` with payloads
    from :func:`read_frame_pages`.  One scatter per layer key."""
    if not assignments:
        return cache
    for key, entry in paged_entries(cache):
        kp, vp = entry["k_pages"], entry["v_pages"]
        rows = _rows([f for f, _ in assignments], kp.device)
        k_rows = np.stack([p[key][0] for _, p in assignments], axis=1)
        v_rows = np.stack([p[key][1] for _, p in assignments], axis=1)
        kp[:, rows] = from_host(k_rows, kp.dtype, kp.device)
        vp[:, rows] = from_host(v_rows, vp.dtype, vp.device)
    return cache


def cow_copy_pages(cache: dict, copies) -> dict:
    """Apply BlockManager CowCopy records to every attention layer's pages,
    in place (device-side row copies, outside the decode step)."""
    if not copies:
        return cache
    for key, entry in paged_entries(cache):
        dev = entry["k_pages"].device
        src = _rows([c.src for c in copies], dev)
        dst = _rows([c.dst for c in copies], dev)
        for name in ("k_pages", "v_pages"):
            entry[name][:, dst] = entry[name][:, src]
    return cache
