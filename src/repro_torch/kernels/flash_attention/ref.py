"""Plain-torch oracle for flash attention (GQA, causal, sliding-window): a
port of ``repro.kernels.flash_attention.ref``.  K3's plain version, and
what ``ops.flash_attention`` runs on CPU tensors."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_mask(q_len: int, kv_len: int, *, causal: bool,
                   window: int | None, device=None) -> torch.Tensor:
    """[q_len, kv_len] boolean mask; True = attend.

    Query positions are the LAST ``q_len`` positions of the ``kv_len``-long
    sequence (standard prefill/decode alignment)."""
    q_pos = torch.arange(q_len, device=device)[:, None] + (kv_len - q_len)
    k_pos = torch.arange(kv_len, device=device)[None, :]
    mask = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    return mask


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, window: int | None = None,
        scale: float | None = None) -> torch.Tensor:
    """Grouped-query attention.

    q: [B, Hq, Sq, D]; k, v: [B, Hkv, Skv, D]; Hq % Hkv == 0.
    Returns [B, Hq, Sq, D] in q.dtype; softmax in float32.
    """
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    assert hq % hkv == 0, (hq, hkv)
    g = hq // hkv
    scale = (d ** -0.5) if scale is None else scale
    qg = q.reshape(b, hkv, g, sq, d).float()
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    mask = attention_mask(sq, skv, causal=causal, window=window,
                          device=q.device)
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.exp(logits - logits.amax(-1, keepdim=True))
    probs = probs / probs.sum(-1, keepdim=True)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v.float())
    return out.reshape(b, hq, sq, d).to(q.dtype)
