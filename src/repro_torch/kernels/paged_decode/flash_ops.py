"""Public decode attention over a contiguous (batch-layout) cache with
backend dispatch (a port of ``repro.kernels.paged_decode.flash_ops``).

``use_kernel=None`` launches K4 (:mod:`.flash`) on CUDA tensors and runs the
plain branch on CPU tensors, the reference's ``use_pallas=_on_tpu()`` with
the card in the TPU's place; asking for the kernel on CPU tensors raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_decode import flash as _k
from repro_torch.kernels.paged_decode import flash_ref as _ref


def _use_kernel(use_kernel: bool | None, q) -> bool:
    return q.device.type == "cuda" if use_kernel is None else use_kernel


def _grouped(q, k):
    """q [B, Hq, D] as K4's [B, Hkv, G, D] against k's Hkv heads.  The
    heads are whatever the caller holds: a tensor-parallel rank's batch
    cache has its own KV heads, and its query heads are whole groups of
    them or, at tp > Hkv, the part of one group that reads its one KV head
    (G = Hq / Hkv either way); query heads that do not split evenly over
    the KV heads raise."""
    b, hq, d = q.shape
    hkv = k.shape[1]
    if hq % hkv:
        raise ValueError(f"{hq} query heads do not split over {hkv} KV heads")
    return q.reshape(b, hkv, hq // hkv, d).contiguous()


def decode_attention(q, k, v, lengths, *, scale: float | None = None,
                     window: int | None = None,
                     use_kernel: bool | None = None) -> torch.Tensor:
    """Single-token decode. q: [B, Hq, D]; k, v: [B, Hkv, S, D] -> [B, Hq, D]."""
    if not _use_kernel(use_kernel, q):
        return _ref.decode_attention(q, k, v, lengths, scale=scale,
                                     window=window)
    out, _, _ = _k.flash_decode(_grouped(q, k), k, v, lengths, scale=scale,
                                window=window)
    return out.reshape(q.shape)


def decode_attention_partial(q, k, v, lengths, *, scale: float | None = None,
                             window: int | None = None,
                             use_kernel: bool | None = None):
    """Partial decode over a KV shard, for a cross-shard merge.  Returns
    (out normalised locally [B, Hq, D], m [B, Hq], l [B, Hq]).  The plain
    branch is K4's plain version: a length-0 row gives (0, -1e30, 0)."""
    b, hq, d = q.shape
    if not _use_kernel(use_kernel, q):
        pos = torch.arange(k.shape[2], device=q.device)[None, :]
        valid = pos < lengths[:, None]
        if window is not None:
            valid &= pos >= (lengths[:, None] - window)
        o, m, l = _ref.decode_attention_partial(q, k, v, valid, scale=scale)
        ln = torch.where(l == 0.0, 1.0, l)
        return (o / ln[..., None]).to(q.dtype), m, l
    out, m, l = _k.flash_decode(_grouped(q, k), k, v, lengths, scale=scale,
                                window=window)
    return out.reshape(b, hq, d), m.reshape(b, hq), l.reshape(b, hq)


def merge_splits(outs, ms, ls):
    """Merge per-shard partials along a leading shard axis, in its order, by
    log-sum-exp: (out [B, Hq, D], m [B, Hq], l [B, Hq]), with an empty merge
    (every l 0) giving (0, -1e30, 0).  What K4 does with its splits' records
    inside a launch.

    outs: [P, B, Hq, D] locally normalised; ms, ls: [P, B, Hq]."""
    m_max = ms.amax(0)
    w = torch.exp(ms - m_max) * ls                        # effective weights
    denom = w.sum(0)
    num = (w[..., None] * outs).sum(0)
    out = num / torch.where(denom == 0.0, 1.0, denom)[..., None]
    return out.to(outs.dtype), m_max, denom


def merge_partials(outs, ms, ls):
    """Merge per-shard partials along a leading shard axis.

    outs: [P, B, Hq, D] locally normalised; ms, ls: [P, B, Hq]."""
    return merge_splits(outs, ms, ls)[0]
