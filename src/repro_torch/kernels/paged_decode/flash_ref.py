"""Plain-torch oracle for single-token decode attention over a contiguous
(batch-layout) KV cache: a port of
``repro.kernels.paged_decode.flash_ref``."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention(q, k, v, lengths, *, scale: float | None = None,
                     window: int | None = None) -> torch.Tensor:
    """One new token attends to its cached history.

    q: [B, Hq, D] (the new token's queries); k, v: [B, Hkv, S, D] (cache;
    positions >= lengths[b] are invalid); lengths: [B] int32, valid cache
    positions INCLUDING the new token (whose k/v must already be written at
    position lengths[b]-1); window: attend to the last ``window``
    positions.  Returns [B, Hq, D].  A length-0 row gets the uniform mean
    of all S cached rows (every logit is -1e30), as in the reference."""
    b, hq, d = q.shape
    _, hkv, s, _ = k.shape
    g = hq // hkv
    scale = (d ** -0.5) if scale is None else scale
    qg = q.reshape(b, hkv, g, d).float()
    logits = torch.einsum("bhgd,bhsd->bhgs", qg, k.float()) * scale
    pos = torch.arange(s, device=q.device)[None, :]
    valid = pos < lengths[:, None]
    if window is not None:
        valid &= pos >= (lengths[:, None] - window)
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    probs = torch.exp(logits - logits.amax(-1, keepdim=True))
    probs = probs / probs.sum(-1, keepdim=True)
    out = torch.einsum("bhgs,bhsd->bhgd", probs, v.float())
    return out.reshape(b, hq, d).to(q.dtype)


def decode_attention_partial(q, k, v, valid_mask, *,
                             scale: float | None = None):
    """Partial flash-decode over a KV shard: (out_unnormalised, m, l).

    q: [B, Hq, D]; k, v: [B, Hkv, S_shard, D]; valid_mask: [B, S_shard]
    bool.  Full attention over the union of shards equals the merge of the
    partials."""
    b, hq, d = q.shape
    _, hkv, s, _ = k.shape
    g = hq // hkv
    scale = (d ** -0.5) if scale is None else scale
    qg = q.reshape(b, hkv, g, d).float()
    logits = torch.einsum("bhgd,bhsd->bhgs", qg, k.float()) * scale
    mask = valid_mask[:, None, None, :]
    logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(-1)                                  # [B, Hkv, G]
    p = torch.where(mask, torch.exp(logits - m[..., None]), 0.0)
    l = p.sum(-1)                                        # [B, Hkv, G]
    out = torch.einsum("bhgs,bhsd->bhgd", p, v.float())
    return out.reshape(b, hq, d), m.reshape(b, hq), l.reshape(b, hq)


def merge_partials(parts):
    """Merge flash-decode partials [(out, m, l), ...] -> [B, Hq, D]."""
    m_all = torch.stack([m for _, m, _ in parts])        # [P, B, H]
    m_max = m_all.amax(0)
    scale = torch.exp(m_all - m_max)                     # [P, B, H]
    l = sum(s * l_ for s, (_, _, l_) in zip(scale, parts))
    o = sum(s[..., None] * o_ for s, (o_, _, _) in zip(scale, parts))
    return (o / torch.where(l == 0.0, 1.0, l)[..., None]).to(parts[0][0].dtype)
