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


def decode_attention(q, k, v, lengths, *, scale: float | None = None,
                     window: int | None = None,
                     use_kernel: bool | None = None) -> torch.Tensor:
    """Single-token decode. q: [B, Hq, D]; k, v: [B, Hkv, S, D] -> [B, Hq, D]."""
    if not _use_kernel(use_kernel, q):
        return _ref.decode_attention(q, k, v, lengths, scale=scale,
                                     window=window)
    b, hq, d = q.shape
    hkv = k.shape[1]
    out, _, _ = _k.flash_decode(q.reshape(b, hkv, hq // hkv, d).contiguous(),
                                k, v, lengths, scale=scale, window=window)
    return out.reshape(b, hq, d)


def decode_attention_partial(q, k, v, lengths, *, scale: float | None = None,
                             window: int | None = None,
                             use_kernel: bool | None = None):
    """Partial decode over a KV shard, for a cross-shard merge.  Returns
    (out normalised locally [B, Hq, D], m [B, Hq], l [B, Hq]).  The plain
    branch is K4's plain version: a length-0 row gives (0, -1e30, 0)."""
    b, hq, d = q.shape
    hkv = k.shape[1]
    if not _use_kernel(use_kernel, q):
        pos = torch.arange(k.shape[2], device=q.device)[None, :]
        valid = pos < lengths[:, None]
        if window is not None:
            valid &= pos >= (lengths[:, None] - window)
        o, m, l = _ref.decode_attention_partial(q, k, v, valid, scale=scale)
        ln = torch.where(l == 0.0, 1.0, l)
        return (o / ln[..., None]).to(q.dtype), m, l
    out, m, l = _k.flash_decode(q.reshape(b, hkv, hq // hkv, d).contiguous(),
                                k, v, lengths, scale=scale, window=window)
    return out.reshape(b, hq, d), m.reshape(b, hq), l.reshape(b, hq)


def merge_partials(outs, ms, ls):
    """Merge per-shard partials along a leading shard axis.

    outs: [P, B, Hq, D] locally normalised; ms, ls: [P, B, Hq]."""
    m_max = ms.amax(0)
    w = torch.exp(ms - m_max) * ls                        # effective weights
    denom = w.sum(0)
    num = (w[..., None] * outs).sum(0)
    return (num / torch.where(denom == 0.0, 1.0, denom)[..., None]).to(outs.dtype)
