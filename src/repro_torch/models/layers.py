"""Model building blocks for decode: parameter tables, norms, RoPE, the QKV
projection, the SwiGLU MLP and the embedding (a port of the decode-path
parts of ``repro.models.layers``).

Parameters are nested dicts of tensors (or the ``nn.ParameterDict``s of
:class:`repro_torch.models.model.Model`, which index the same way).
``*_defs(cfg)`` return matching nested dicts of :class:`ParamDef`, from
which the model draws its weights with the reference's distributions.
"""
from __future__ import annotations

import dataclasses

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
    init: str = "normal"          # normal | zeros | ones
    scale: float | None = None    # stddev for "normal" (default fan-in)

    def initialize(self, gen: torch.Generator, dtype: torch.dtype,
                   device) -> torch.Tensor:
        """Draw the tensor from ``gen`` (which must live on ``device``) with
        the reference's distribution, in f32, then cast to ``dtype``."""
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype, device=device)
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
