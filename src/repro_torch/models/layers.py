"""Model building blocks: parameter tables, norms, RoPE, the QKV
projection, full-sequence and batch-layout decode attention, the SwiGLU MLP
and the embedding (a port of ``repro.models.layers`` for the dense family;
cross-attention waits for the enc-dec slice).

Parameters are nested dicts of tensors (or the ``nn.ParameterDict``s of
:class:`repro_torch.models.model.Model`, which index the same way).
``*_defs(cfg)`` return matching nested dicts of :class:`ParamDef`, from
which the model draws its weights with the reference's distributions.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Parameter tables
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    init: str = "normal"          # normal | zeros | ones | ssm_a | ssm_dt
    scale: float | None = None    # stddev for "normal" (default fan-in)

    def initialize(self, gen: torch.Generator, dtype: torch.dtype,
                   device) -> torch.Tensor:
        """Draw the tensor from ``gen`` (which must live on ``device``) with
        the reference's distribution, in f32, then cast to ``dtype``."""
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype, device=device)
        if self.init in ("ssm_a", "ssm_dt"):
            # A_log: log of U[1, 16]; dt bias: U[log 1e-3, log 1e-1]
            lo, hi = ((1.0, 16.0) if self.init == "ssm_a"
                      else (math.log(1e-3), math.log(1e-1)))
            u = torch.rand(self.shape, generator=gen, dtype=torch.float32,
                           device=device) * (hi - lo) + lo
            return (torch.log(u) if self.init == "ssm_a" else u).to(dtype)
        # the leading dim of a stacked [n_periods, ...] def counts as its
        # fan-in, exactly as in the reference
        fan_in = self.shape[0] if len(self.shape) > 1 else self.shape[-1]
        std = self.scale if self.scale is not None else fan_in ** -0.5
        x = torch.randn(self.shape, generator=gen, dtype=torch.float32,
                        device=device)
        return (x * std).to(dtype)


def stack_defs(defs: dict, n: int) -> dict:
    """Prepend a period ("layers") dimension to every ParamDef."""
    return {k: stack_defs(v, n) if isinstance(v, dict)
            else ParamDef((n,) + v.shape, v.init, v.scale)
            for k, v in defs.items()}


# ---------------------------------------------------------------------------
# Norms and positional encodings
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm in f32, cast back to the input dtype BEFORE the weight
    multiply (as the reference does)."""
    dt = x.dtype
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * weight


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding in f32, cast back to ``x.dtype``.  x: [..., S, D]
    (D even); positions: [..., S]."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs               # [..., S, half]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention projections
# ---------------------------------------------------------------------------
def attention_defs(cfg: ModelConfig) -> dict:
    d, hd = cfg.d_model, cfg.hd
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    defs = {
        "wq": ParamDef((d, nq)),
        "wk": ParamDef((d, nkv)),
        "wv": ParamDef((d, nkv)),
        "wo": ParamDef((nq, d)),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((nq,), "zeros")
        defs["bk"] = ParamDef((nkv,), "zeros")
        defs["bv"] = ParamDef((nkv,), "zeros")
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((hd,), "ones")
        defs["k_norm"] = ParamDef((hd,), "ones")
    return defs


def project_qkv(cfg: ModelConfig, p, x: torch.Tensor,
                positions: torch.Tensor, rotary: bool = True):
    """x: [B, S, d] -> q [B, H, S, hd], k/v [B, Hkv, S, hd]."""
    b, s, _ = x.shape
    hd = cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, cfg.n_heads, hd).transpose(1, 2)
    k = k.reshape(b, s, cfg.n_kv_heads, hd).transpose(1, 2)
    v = v.reshape(b, s, cfg.n_kv_heads, hd).transpose(1, 2)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.rms_eps)
        k = rms_norm(k, p["k_norm"], cfg.rms_eps)
    if rotary:
        q = rope(q, positions[:, None, :], cfg.rope_theta)
        k = rope(k, positions[:, None, :], cfg.rope_theta)
    return q, k, v


def _pick(s: int, c: int) -> int:
    """The largest chunk <= c that divides s."""
    c = min(c, s)
    while s % c:
        c -= 1
    return c


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, window: int | None, chunk_q: int,
                      chunk_k: int, kv_valid_len=None) -> torch.Tensor:
    """Flash-equivalent attention in plain torch: an online softmax over KV
    chunks inside a loop over Q chunks (the reference's two ``lax.scan``s),
    never materialising the [Sq, Skv] logits.

    q: [B, Hq, Sq, D]; k, v: [B, Hkv, Skv, D]; kv_valid_len: [B] optional
    valid KV prefix lengths.  Queries sit at the tail of the KV sequence."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    g = hq // hkv
    scale = d ** -0.5
    cq, ck = _pick(sq, chunk_q), _pick(skv, chunk_k)
    nq, nk = sq // cq, skv // ck
    qf = q.reshape(b, hkv, g, nq, cq, d).float() * scale
    kf = k.reshape(b, hkv, nk, ck, d).float()
    vf = v.reshape(b, hkv, nk, ck, d).float()
    q_base = skv - sq
    dev = q.device
    outs = []
    for qi in range(nq):
        qc = qf[:, :, :, qi]                           # [B, Hkv, G, cq, D]
        q_pos = q_base + qi * cq + torch.arange(cq, device=dev)
        m = torch.full((b, hkv, g, cq), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, hkv, g, cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, hkv, g, cq, d), dtype=torch.float32, device=dev)
        for kj in range(nk):
            kc, vc = kf[:, :, kj], vf[:, :, kj]        # [B, Hkv, ck, D]
            s = torch.einsum("bhgqd,bhkd->bhgqk", qc, kc)
            k_pos = kj * ck + torch.arange(ck, device=dev)
            mask = torch.ones((cq, ck), dtype=torch.bool, device=dev)
            if causal:
                mask &= q_pos[:, None] >= k_pos[None, :]
            if window is not None:
                mask &= (q_pos[:, None] - k_pos[None, :]) < window
            mask = mask.expand(s.shape)
            if kv_valid_len is not None:
                mask = mask & (k_pos[None, :] < kv_valid_len[:, None])[
                    :, None, None, None, :]
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("bhgqk,bhkd->bhgqd",
                                                        p, vc)
            m = m_new
        outs.append(acc / torch.where(l == 0.0, 1.0, l)[..., None])
    out = torch.stack(outs, dim=3)                     # [B, Hkv, G, nq, cq, D]
    return out.reshape(b, hq, sq, d).to(q.dtype)


def full_attention(cfg: ModelConfig, q, k, v, *, causal: bool,
                   window: int | None, kv_valid_len=None) -> torch.Tensor:
    """Dispatch on ``cfg.attn_impl``: ``"pallas"`` is K3 through
    :func:`repro_torch.kernels.flash_attention.ops.flash_attention` (the
    CUDA kernel on CUDA tensors, the plain oracle on CPU ones); ``"ref"``
    the plain oracle :func:`~repro_torch.kernels.flash_attention.ref.mha`;
    ``"chunked"`` and ``"chunked_unrolled"`` :func:`chunked_attention`.  The
    reference's unrolled form exists for XLA cost probes and skips fully
    masked chunk pairs, which leaves the online softmax unchanged (their
    probabilities are 0 and their rescale factor 1): the same arithmetic."""
    impl = cfg.attn_impl
    if impl == "pallas":
        from repro_torch.kernels.flash_attention import ops as fa_ops
        assert kv_valid_len is None
        return fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    if impl == "ref":
        from repro_torch.kernels.flash_attention import ref as fa_ref
        assert kv_valid_len is None
        return fa_ref.mha(q, k, v, causal=causal, window=window)
    if impl in ("chunked", "chunked_unrolled"):
        assert impl == "chunked" or kv_valid_len is None
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 chunk_q=cfg.attn_chunk_q,
                                 chunk_k=cfg.attn_chunk_k,
                                 kv_valid_len=kv_valid_len)
    raise ValueError(f"unknown attn_impl {impl!r}")


def attention_block(cfg: ModelConfig, p, x: torch.Tensor,
                    positions: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Full-sequence attention (forward / prefill without cache)."""
    b, s, _ = x.shape
    q, k, v = project_qkv(cfg, p, x, positions)
    out = full_attention(cfg, q, k, v, causal=causal, window=cfg.window)
    out = out.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.hd)
    return out @ p["wo"]


def decode_attention_block(cfg: ModelConfig, p, x: torch.Tensor,
                           k_cache: torch.Tensor, v_cache: torch.Tensor,
                           lengths: torch.Tensor, write_mask=None):
    """One-token decode with a batch-layout cache, updated IN PLACE.

    x: [B, 1, d]; k_cache/v_cache: [B, Hkv, S_max, hd]; lengths: [B] count
    INCLUDING the new token.  Returns (out [B, 1, d], k_cache, v_cache).

    As in the reference, the new K/V row is written at ``lengths - 1``
    before attending, and a length-0 row (index -1) writes nothing: the
    write goes through a gather/scatter at the clamped index that puts the
    old row back where nothing is to be written, never through the -1
    sentinel, which would wrap to the last position.  Rows that
    ``write_mask`` turns off attend with the new row as the reference's do,
    and then get their old row back (the reference's ``_mask_entry``)."""
    b = x.shape[0]
    positions = (lengths - 1)[:, None]
    q, k_new, v_new = project_qkv(cfg, p, x, positions)
    s_max = k_cache.shape[2]
    ix = (lengths.long() - 1).clamp(0, s_max - 1)
    ix = ix.view(b, 1, 1, 1).expand(b, cfg.n_kv_heads, 1, cfg.hd)
    hit = ((lengths >= 1) & (lengths <= s_max)).view(b, 1, 1, 1)
    saved = []
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        old = cache.gather(2, ix)
        row = torch.where(hit, new.to(cache.dtype), old)
        cache.scatter_(2, ix, row)
        saved.append((cache, old, row))
    if cfg.attn_impl == "pallas":
        from repro_torch.kernels.paged_decode.flash_ops import decode_attention
        out = decode_attention(q[:, :, 0], k_cache, v_cache, lengths,
                               window=cfg.window)
    else:
        from repro_torch.kernels.paged_decode import flash_ref
        out = flash_ref.decode_attention(q[:, :, 0], k_cache, v_cache,
                                         lengths, window=cfg.window)
    if write_mask is not None:
        keep = write_mask.view(b, 1, 1, 1)
        for cache, old, row in saved:
            cache.scatter_(2, ix, torch.where(keep, row, old))
    out = out.reshape(b, 1, cfg.n_heads * cfg.hd)
    return out @ p["wo"], k_cache, v_cache


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------
def mlp_defs(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    return {
        "w_gate": ParamDef((d, f)),
        "w_up": ParamDef((d, f)),
        "w_down": ParamDef((f, d)),
    }


def mlp_block(p, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# Embeddings / head
# ---------------------------------------------------------------------------
def embedding_defs(cfg: ModelConfig) -> dict:
    defs = {"tok": ParamDef((cfg.vocab_padded, cfg.d_model), scale=1.0)}
    if not cfg.tie_embeddings:
        defs["head"] = ParamDef((cfg.d_model, cfg.vocab_padded))
    return defs


def embed_tokens(cfg: ModelConfig, p, ids: torch.Tensor) -> torch.Tensor:
    return p["tok"][ids]


def unembed(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ p["tok"].T
    return x @ p["head"]


def norm_defs(cfg: ModelConfig) -> dict:
    return {"w": ParamDef((cfg.d_model,), "ones")}
