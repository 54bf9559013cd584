"""Impl selection for the per-shard paged decode step (a port of
``repro.kernels.paged_decode.ops``).

:func:`paged_decode_shard` is the single entry the dispatch layer
(:mod:`repro_torch.parallel.paged_attention`) calls.  Both impls honour one
contract -- masked K/V WRITE into the owning pages, then UNNORMALISED
partial-attention statistics (acc, m, l) over the pages this shard owns --
so a caller's log-sum-exp merge is impl-independent:

``composed``   host-style owner masks + torch scatter/einsum
               (:mod:`repro_torch.kernels.paged_decode.ref`) -- the oracle,
               and what ``auto`` runs on CPU tensors;
``fused``      the VM-walking CUDA kernels
               (:mod:`repro_torch.kernels.paged_decode.kernel`): K1
               ``paged_qkv_write`` (with the q/k norm and rotary) then K2;
               CUDA tensors only, since a CUDA kernel has no interpret mode.

Without VM tables (``use_vm=False``) the fused path synthesizes the identity
block table -- sequence ``b`` owns frames ``b*max_pages ..`` -- so the
kernels always walk a table, while the composed path keeps its direct
arithmetic mapping.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_decode import kernel as _k
from repro_torch.kernels.paged_decode import ref as _ref


def resolve_impl(paged_kernel: str, hl: int, group: int,
                 device: torch.device) -> str:
    """Map the ModelConfig ``paged_kernel`` flag + the tensors' device to an
    impl: ``auto`` is ``fused`` on CUDA and ``composed`` on the CPU;
    ``fused`` on the CPU raises; ``composed`` is honoured everywhere.  The
    kernels walk whole KV-head groups, so ``hl`` local query heads that
    split a group raise (a misconfigured tensor-parallel split), on the CPU
    too, where ``auto`` stands for the card's path; only ``composed``, and
    ``auto`` on ``meta`` tensors (the dry-run counts the plain path), take
    such a shard, as the reference's composed path does."""
    device = torch.device(device)
    if paged_kernel == "composed" or (paged_kernel == "auto"
                                      and device.type == "meta"):
        return "composed"
    if hl % group:
        raise ValueError(f"{hl} local query heads do not split into whole "
                         f"KV-head groups of {group}")
    if paged_kernel == "fused":
        if device.type != "cuda":
            raise RuntimeError("paged_kernel='fused' needs CUDA tensors: the "
                               "CUDA kernels have no CPU interpret mode")
        return "fused"
    if paged_kernel == "auto":
        return "fused" if device.type == "cuda" else "composed"
    raise ValueError(f"unknown paged_kernel {paged_kernel!r}")


def _identity_tables(b: int, max_pages: int, device):
    """The batch layout's fixed mapping, materialized as VM tables."""
    bt = (torch.arange(b, dtype=torch.int32, device=device)[:, None] * max_pages
          + torch.arange(max_pages, dtype=torch.int32, device=device)[None, :])
    fr = torch.zeros((b * max_pages,), dtype=torch.bool, device=device)
    return bt, fr


def qk_rotate(q, k, lengths, **epilogue):
    """The decode step's q/k norm and rotary at position ``lengths - 1``
    (``epilogue`` as ``L.qk_epilogue_args`` gives it) without a page write,
    for the batch layout: K1 with its write off on CUDA tensors, its plain
    version ``ref.qk_rotate`` on CPU ones.  q: [B, Hq, D], k: [B, Hkv, D]."""
    rotate = _k.qk_rotate if q.device.type == "cuda" else _ref.qk_rotate
    return rotate(q, k, lengths, **epilogue)


def paged_decode_shard(q, k_new, v_new, k_pages, v_pages, lengths, bt, fl,
                       fr, wm, *, sid, n_shards, head_start, group, window,
                       max_pages, use_vm, impl, q_norm=None, k_norm=None,
                       eps=1e-6, rope_theta=None):
    """One shard of the paged decode step.

    q: [B, Hl, hd] local query heads (whole KV-head groups);
    k_new/v_new: [B, Hkv, hd]; k/v_pages: [np_loc, slots, Hkv, hd] local,
    updated IN PLACE; bt/fl/fr: replicated VM tables (ignored when
    ``use_vm`` is False); wm: [B] write mask.  q and k_new are the raw
    projections when ``q_norm``/``k_norm`` (the ``qk_norm`` weights) or
    ``rope_theta`` are given, which the step applies first: ``fused`` in K1
    (``paged_qkv_write``), ``composed`` as ``ref.qkv_write``.
    Returns (acc [B, Hl, hd] f32 unnormalized, m [B, Hl], l [B, Hl],
    k_pages, v_pages)."""
    epilogue = dict(q_norm=q_norm, k_norm=k_norm, eps=eps,
                    rope_theta=rope_theta)
    if impl == "composed":
        return _ref.paged_decode_shard(
            q, k_new, v_new, k_pages, v_pages, lengths, bt, fl, fr, wm,
            sid=sid, n_shards=n_shards, head_start=head_start, group=group,
            window=window, max_pages=max_pages, use_vm=use_vm, **epilogue)
    if impl != "fused":
        raise ValueError(f"unknown impl {impl!r}")
    if q.device.type != "cuda":
        raise RuntimeError("the fused paged-decode kernels need CUDA tensors")
    b, hl, hd = q.shape
    if use_vm:
        bt_use, fr_use = bt, fr
    else:
        bt_use, fr_use = _identity_tables(b, max_pages, q.device)
    meta = (sid, n_shards, head_start // group)
    q = _k.paged_qkv_write(q, k_new, v_new, k_pages, v_pages, bt_use, lengths,
                           fr_use, wm, meta, **epilogue)
    qg = q.reshape(b, hl // group, group, hd)
    acc, m, l = _k.paged_gather_attend(qg, k_pages, v_pages, bt_use, lengths,
                                       meta, window=window)
    return (acc.reshape(b, hl, hd), m.reshape(b, hl), l.reshape(b, hl),
            k_pages, v_pages)
