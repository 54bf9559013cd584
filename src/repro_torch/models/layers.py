"""Model building blocks: parameter tables, norms, RoPE, the QKV
projection, full-sequence, cross and batch-layout decode attention, the
SwiGLU MLP and the embedding (a port of ``repro.models.layers``).

Parameters are nested dicts of tensors (or the ``nn.ParameterDict``s of
:class:`repro_torch.models.model.Model`, which index the same way).
``*_defs(cfg)`` return matching nested dicts of :class:`ParamDef` (shape,
logical axes, initializer), from which the model draws its weights with the
reference's distributions and :func:`build_axes` / :func:`build_shapes`
derive the sharding rules' inputs.

A tensor-parallel rank's split form holds its own shards of these tables
(:func:`repro_torch.parallel.sharding.tp_shard_params`): every block reads
its head, column and vocab counts from the weights it holds, and where
they are a shard it sums its row-parallel output (``wo`` of self- and
cross-attention, ``w_down``), its embedding, or gathers its logits over
the mesh context's tp group.  Under autograd (a train step on the split
form) the replicated input of each split product enters its region
through ``mesh_ctx.to_region``, whose gradient is summed over tp, and the
loss is taken over the rank's vocab block (:func:`lm_head_loss`) without
gathering the logits.  Whole weights compute as on one device, under a
context or not.

Logical axis names (the reference's):
  "layers"   -- stacked layer-period dimension
  "embed"    -- d_model
  "q_heads"  -- flattened n_heads * head_dim
  "kv_heads" -- flattened n_kv_heads * head_dim
  "mlp"      -- d_ff
  "experts"  -- MoE expert dimension
  "vocab"    -- (padded) vocabulary
  "ssm_inner"-- mamba inner width
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.parallel import mesh_ctx

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Parameter tables
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"          # normal | zeros | ones | ssm_a | ssm_dt
    scale: float | None = None    # stddev for "normal" (default fan-in)

    def initialize(self, gen: torch.Generator, dtype: torch.dtype,
                   device) -> torch.Tensor:
        """Draw the tensor from ``gen`` (which must live on ``device``) with
        the reference's distribution, in f32, then cast to ``dtype``.  On
        the ``meta`` device nothing is drawn (``gen`` may be None): the
        tensor has the shape and dtype alone."""
        if torch.device(device).type == "meta":
            return torch.empty(self.shape, dtype=dtype, device="meta")
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
        # scaled in place: a stacked expert table's f32 draw is twice its
        # bf16 size, and one more copy of it need not fit beside the model
        return x.mul_(std).to(dtype)


def _map_defs(fn, defs: dict) -> dict:
    return {k: _map_defs(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in defs.items()}


def build_axes(defs: dict) -> dict:
    """The logical axes of every ParamDef, as a tree of tuples."""
    return _map_defs(lambda d: d.axes, defs)


def build_shapes(defs: dict, dtype: torch.dtype) -> dict:
    """Every ParamDef as a tensor on the ``meta`` device (shape and dtype,
    no storage): the reference's ``ShapeDtypeStruct`` tree."""
    return _map_defs(lambda d: torch.empty(d.shape, dtype=dtype,
                                           device="meta"), defs)


def stack_defs(defs: dict, n: int) -> dict:
    """Prepend a period ("layers") dimension to every ParamDef."""
    return _map_defs(lambda d: ParamDef((n,) + d.shape, ("layers",) + d.axes,
                                        d.init, d.scale), defs)


# ---------------------------------------------------------------------------
# Norms and positional encodings
# ---------------------------------------------------------------------------
#: float8_e4m3fn's largest value, 448, and half a step above it: past this
#: the reference's cast (ml_dtypes, round to nearest even) gives NaN
E4M3_ROUNDS_TO_NAN = 464.0


def cast_kv(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in a K/V cache's ``dtype`` with the bits of the reference's
    ``astype``: torch's cast, which rounds to nearest even as ml_dtypes
    does, except that into float8_e4m3fn torch saturates at 448 where the
    reference gives NaN (with ``x``'s sign) past 464, infinities
    included."""
    y = x.to(dtype)
    if dtype != torch.float8_e4m3fn or x.dtype == dtype:
        return y
    nan = torch.signbit(x).to(torch.uint8) << 7 | 0x7F
    return torch.where(x.abs() > E4M3_ROUNDS_TO_NAN, nan,
                       y.view(torch.uint8)).view(dtype)


def _as_bits(t: torch.Tensor) -> torch.Tensor:
    """A one-byte float cache as its uint8 bits (a view), which gather and
    scatter take on the CPU, bit for bit; other caches as they are."""
    return t.view(torch.uint8) if t.is_floating_point() \
        and t.element_size() == 1 else t


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm in f32, cast back to the input dtype BEFORE the weight
    multiply (as the reference does)."""
    dt = x.dtype
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * weight


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding in f32, cast back to ``x.dtype``.  x: [..., S, D]
    (D even); positions: [..., S].

    M-RoPE (qwen2-vl's ``mrope_sections``) degenerates to this 1-D rotary
    for text-shaped inputs: the vision frontend is a stub fed frame
    embeddings, so the temporal section is the only active one and the
    sections change no value (as in the reference)."""
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
        "wq": ParamDef((d, nq), ("embed", "q_heads")),
        "wk": ParamDef((d, nkv), ("embed", "kv_heads")),
        "wv": ParamDef((d, nkv), ("embed", "kv_heads")),
        "wo": ParamDef((nq, d), ("q_heads", "embed")),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((nq,), ("q_heads",), "zeros")
        defs["bk"] = ParamDef((nkv,), ("kv_heads",), "zeros")
        defs["bv"] = ParamDef((nkv,), ("kv_heads",), "zeros")
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((hd,), (None,), "ones")
        defs["k_norm"] = ParamDef((hd,), (None,), "ones")
    return defs


def local_heads(cfg: ModelConfig, p) -> tuple[int, int]:
    """(query heads, KV heads) the attention weights ``p`` hold: the
    config's, or a tensor-parallel rank's whole-head shard of them."""
    return p["wq"].shape[-1] // cfg.hd, p["wk"].shape[-1] // cfg.hd


def row_parallel_sum(parts) -> torch.Tensor:
    """The sum of ``parts``, triples ``(y, held, whole)`` of a product ``y``
    through weights that hold ``held`` of a dim's ``whole`` rows: where
    ``held < whole`` they are a tensor-parallel rank's shard (the split
    form) and ``y`` is its partial sum.  The partials are added and summed
    over the tp group in one call, and the whole products added after:
    the one place a block decides from its weights whether to sum."""
    out = None
    split = [y for y, held, whole in parts if held < whole]
    if split:
        out = mesh_ctx.tp_sum(sum(split[1:], split[0]))
    for y, held, whole in parts:
        if held >= whole:
            out = y if out is None else out + y
    return out


def attention_out(cfg: ModelConfig, p, out: torch.Tensor) -> torch.Tensor:
    """The attention's heads [..., Hl * hd] through ``wo``
    (:func:`row_parallel_sum`: a rank's rows of ``wo`` give a partial)."""
    wo = p["wo"]
    return row_parallel_sum([(out @ wo, wo.shape[0], cfg.n_heads * cfg.hd)])


def region_input(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """``x`` as the input of the attention ``p``: through
    ``mesh_ctx.to_region`` where ``p`` holds a tensor-parallel rank's query
    heads, whose work is then a region of the split form."""
    split = p["wq"].shape[-1] < cfg.n_heads * cfg.hd
    return mesh_ctx.to_region(x) if split else x


def project(cfg: ModelConfig, p, name: str, x: torch.Tensor) -> torch.Tensor:
    """``x @ w<name>`` for ``name`` "q", "k" or "v", bias added where the
    config has one: the heads ``p`` holds.  ``x`` is the region's input
    (:func:`region_input`)."""
    y = x @ p["w" + name]
    return y + p["b" + name] if cfg.qkv_bias else y


def qkv_projections(cfg: ModelConfig, p, x: torch.Tensor):
    """The projections of :func:`project_qkv`: x [B, S, d] -> q
    [B, S, H * hd], k/v [B, S, Hkv * hd], bias added."""
    x = region_input(cfg, p, x)
    return tuple(project(cfg, p, name, x) for name in "qkv")


def qk_epilogue(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
                *, q_norm=None, k_norm=None, eps: float = 1e-6,
                rope_theta: float | None = None):
    """The norm and rotary epilogue of :func:`project_qkv`: the RMS norm of
    q and k when ``q_norm``/``k_norm`` are given, then the rotary at
    ``positions`` unless ``rope_theta`` is None.  q [B, H, S, hd], k
    [B, Hkv, S, hd]; positions [B, S]."""
    if q_norm is not None:
        q = rms_norm(q, q_norm, eps)
        k = rms_norm(k, k_norm, eps)
    if rope_theta is not None:
        q = rope(q, positions[:, None, :], rope_theta)
        k = rope(k, positions[:, None, :], rope_theta)
    return q, k


def qk_epilogue_args(cfg: ModelConfig, p, rotary: bool = True) -> dict:
    """:func:`qk_epilogue`'s keyword arguments for ``cfg``: the ``qk_norm``
    weights (None without it), eps and theta (None without the rotary)."""
    return dict(q_norm=p["q_norm"] if cfg.qk_norm else None,
                k_norm=p["k_norm"] if cfg.qk_norm else None,
                eps=cfg.rms_eps, rope_theta=cfg.rope_theta if rotary else None)


def project_qkv(cfg: ModelConfig, p, x: torch.Tensor,
                positions: torch.Tensor, rotary: bool = True):
    """x: [B, S, d] -> q [B, H, S, hd], k/v [B, Hkv, S, hd] (the heads ``p``
    holds)."""
    b, s, _ = x.shape
    hd = cfg.hd
    h, hkv = local_heads(cfg, p)
    q, k, v = qkv_projections(cfg, p, x)
    q = q.reshape(b, s, h, hd).transpose(1, 2)
    k = k.reshape(b, s, hkv, hd).transpose(1, 2)
    v = v.reshape(b, s, hkv, hd).transpose(1, 2)
    q, k = qk_epilogue(q, k, positions, **qk_epilogue_args(cfg, p, rotary))
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
    never materialising the [Sq, Skv] logits.  Chunk pairs that the causal
    mask or the window masks whole are skipped, as K3 skips its blocks:
    their probabilities would be 0 at a rescale factor of 1, so the values
    do not change and the work (what the dry-run counts) is the kernel's.

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
        q_lo, q_hi = q_base + qi * cq, q_base + (qi + 1) * cq - 1
        for kj in range(nk):
            if causal and kj * ck > q_hi:
                continue                      # fully above the diagonal
            if window is not None and (kj + 1) * ck - 1 < q_lo - window + 1:
                continue                      # fully left of every window
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


#: The reference's name for the form that skips fully masked chunk pairs
#: (its dry-run's cost probes); :func:`chunked_attention` skips them always.
chunked_attention_unrolled = chunked_attention


def full_attention(cfg: ModelConfig, q, k, v, *, causal: bool,
                   window: int | None, kv_valid_len=None) -> torch.Tensor:
    """Dispatch on ``cfg.attn_impl``: ``"pallas"`` is K3 through
    :func:`repro_torch.kernels.flash_attention.ops.flash_attention` (the
    CUDA kernel on CUDA tensors, the plain oracle on CPU ones); ``"ref"``
    the plain oracle :func:`~repro_torch.kernels.flash_attention.ref.mha`;
    ``"chunked"`` and ``"chunked_unrolled"`` :func:`chunked_attention`.  The
    reference's unrolled form exists for XLA cost probes and skips fully
    masked chunk pairs, which :func:`chunked_attention` always does."""
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
    return attention_out(cfg, p, out.transpose(1, 2).reshape(b, s, -1))


def cross_attention_block(cfg: ModelConfig, p, x: torch.Tensor,
                          kv_cache) -> torch.Tensor:
    """Decoder cross-attention against precomputed encoder K/V (no rotary
    on q or k, as in the reference).  x: [B, S, d]; kv_cache: (k, v) of
    [B, Hkv, S_src, hd] (the heads ``p`` holds, a tensor-parallel rank's
    included: its ``wo`` rows then give a partial sum, summed by
    :func:`attention_out`).  Non-causal, no window: under ``"pallas"`` it
    is K3 with the queries taking every source position, Sq > S_src
    included."""
    b, s, _ = x.shape
    h = local_heads(cfg, p)[0]
    q = project(cfg, p, "q", region_input(cfg, p, x)).reshape(
        b, s, h, cfg.hd).transpose(1, 2)
    k, v = kv_cache
    out = full_attention(cfg, q, k, v, causal=False, window=None)
    return attention_out(cfg, p, out.transpose(1, 2).reshape(b, s, h * cfg.hd))


def encode_kv(cfg: ModelConfig, p, enc_out: torch.Tensor):
    """Cross-attention K/V [B, Hkv, S_src, hd] from encoder states (the KV
    heads ``p`` holds)."""
    b, s, _ = enc_out.shape
    hkv = local_heads(cfg, p)[1]
    enc_out = region_input(cfg, p, enc_out)
    return tuple(project(cfg, p, name, enc_out).reshape(
        b, s, hkv, cfg.hd).transpose(1, 2) for name in "kv")


def decode_attention_block(cfg: ModelConfig, p, x: torch.Tensor,
                           k_cache: torch.Tensor, v_cache: torch.Tensor,
                           lengths: torch.Tensor, write_mask=None):
    """One-token decode with a batch-layout cache, updated IN PLACE.

    x: [B, 1, d]; k_cache/v_cache: [B, Hkv, S_max, hd] (the KV heads ``p``
    holds); lengths: [B] count INCLUDING the new token.  Returns (out
    [B, 1, d], k_cache, v_cache).

    As in the reference, the new K/V row is written at ``lengths - 1``
    before attending, and a length-0 row (index -1) writes nothing: the
    write goes through a gather/scatter at the clamped index that puts the
    old row back where nothing is to be written, never through the -1
    sentinel, which would wrap to the last position.  Rows that
    ``write_mask`` turns off attend with the new row as the reference's do,
    and then get their old row back (the reference's ``_mask_entry``).
    The row is cast as the reference casts it (:func:`cast_kv`); a
    one-byte (fp8) cache is written through its bits.
    With ``attn_impl="pallas"`` the q/k norm and rotary go through
    ``ops.qk_rotate``: on CUDA tensors one K1 launch with its page write
    off."""
    b, hd = x.shape[0], cfg.hd
    h, hkv = local_heads(cfg, p)
    if cfg.attn_impl == "pallas":
        from repro_torch.kernels.paged_decode import ops as pd_ops
        q, k_new, v_new = qkv_projections(cfg, p, x)
        q, k_new = pd_ops.qk_rotate(q.view(b, h, hd), k_new.view(b, hkv, hd),
                                    lengths, **qk_epilogue_args(cfg, p))
        q, k_new = q[:, :, None], k_new[:, :, None]
        v_new = v_new.view(b, hkv, 1, hd)
    else:
        q, k_new, v_new = project_qkv(cfg, p, x, (lengths - 1)[:, None])
    s_max = k_cache.shape[2]
    ix = (lengths.long() - 1).clamp(0, s_max - 1)
    ix = ix.view(b, 1, 1, 1).expand(b, hkv, 1, hd)
    hit = ((lengths >= 1) & (lengths <= s_max)).view(b, 1, 1, 1)
    saved = []
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        bits = _as_bits(cache)
        old = bits.gather(2, ix)
        row = torch.where(hit, _as_bits(cast_kv(new, cache.dtype)), old)
        bits.scatter_(2, ix, row)
        saved.append((bits, old, row))
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
    return attention_out(cfg, p, out.reshape(b, 1, h * hd)), k_cache, v_cache


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------
def mlp_defs(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    return {
        "w_gate": ParamDef((d, f), ("embed", "mlp")),
        "w_up": ParamDef((d, f), ("embed", "mlp")),
        "w_down": ParamDef((f, d), ("mlp", "embed")),
    }


def swiglu(p, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU over the columns ``p`` holds: the block's output, or a
    tensor-parallel rank's partial sum of it."""
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


def mlp_block(p, x: torch.Tensor, d_ff: int) -> torch.Tensor:
    """SwiGLU of hidden width ``d_ff`` (:func:`row_parallel_sum`: a rank's
    columns give a partial, of ``x`` entered into their region)."""
    held = p["w_down"].shape[0]
    if held < d_ff:
        x = mesh_ctx.to_region(x)
    return row_parallel_sum([(swiglu(p, x), held, d_ff)])


# ---------------------------------------------------------------------------
# Embeddings / head
# ---------------------------------------------------------------------------
def embedding_defs(cfg: ModelConfig) -> dict:
    defs = {"tok": ParamDef((cfg.vocab_padded, cfg.d_model),
                            ("vocab", "embed"), scale=1.0)}
    if not cfg.tie_embeddings:
        defs["head"] = ParamDef((cfg.d_model, cfg.vocab_padded),
                                ("embed", "vocab"))
    return defs


def vocab_split(cfg: ModelConfig, p) -> bool:
    """Whether ``p`` holds a tensor-parallel rank's block of the vocab."""
    return p["tok"].shape[0] < cfg.vocab_padded


def embed_tokens(cfg: ModelConfig, p, ids: torch.Tensor) -> torch.Tensor:
    """The rows of ``ids``.  Over a rank's vocab block, ids outside it give
    zeros and the sum over the tp group gives every row."""
    tok = p["tok"]
    if not vocab_split(cfg, p):
        return tok[ids]
    n = tok.shape[0]
    local = ids - mesh_ctx.tp_index() * n
    mine = (local >= 0) & (local < n)
    x = torch.where(mine[..., None], tok[local.clamp(0, n - 1)], 0)
    return mesh_ctx.tp_sum(x)


def unembed(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """The logits of the vocab ``p`` holds (a rank's block of columns)."""
    if cfg.tie_embeddings:
        return x @ p["tok"].T
    return x @ p["head"]


def masked_logits(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """Unembed ``x`` to f32 logits with the padded vocab columns at
    ``NEG_INF``; a rank's vocab block is gathered over the tp group into
    every column first, so every rank holds (and samples from) the same
    logits."""
    logits = unembed(cfg, p, x).float()
    if vocab_split(cfg, p):
        parts = mesh_ctx.tp_gather(logits)          # [tp, ..., V / tp]
        logits = parts.movedim(0, -2).reshape(*logits.shape[:-1], -1)
    if cfg.vocab_padded != cfg.vocab_size:
        pad = torch.arange(cfg.vocab_padded, device=logits.device) \
            >= cfg.vocab_size
        logits = torch.where(pad, NEG_INF, logits)
    return logits


def vocab_nll(cfg: ModelConfig, p, x: torch.Tensor,
              labels: torch.Tensor) -> torch.Tensor:
    """Per-token ``logsumexp - gold`` [B, S] in f32 over a rank's vocab
    block, never gathering the logits: the rank's f32 logits of ``x``
    (entered into the region) with its padded columns at ``NEG_INF``, a
    max all-reduce (no gradient) to shift them, then one sum all-reduce of
    [sum of exponentials, gold logit] -- the gold from the rank whose block
    holds the label, zero elsewhere.  The sum's gradient passes through to
    every rank, so each takes its block's logits' gradient and the
    region's input sums them."""
    logits = unembed(cfg, p, mesh_ctx.to_region(x)).float()
    n = logits.shape[-1]
    lo = mesh_ctx.tp_index() * n
    if cfg.vocab_padded != cfg.vocab_size:
        col = torch.arange(lo, lo + n, device=logits.device)
        logits = torch.where(col >= cfg.vocab_size, NEG_INF, logits)
    m = mesh_ctx.tp_max(logits.amax(-1))
    local = labels.long() - lo
    mine = (local >= 0) & (local < n)
    gold = logits.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
    part = torch.stack([torch.exp(logits - m[..., None]).sum(-1),
                        torch.where(mine, gold, 0.0)])
    sumexp, gold = mesh_ctx.tp_sum(part).unbind(0)
    return torch.log(sumexp) + m - gold


def lm_head_loss(cfg: ModelConfig, p, x: torch.Tensor, labels: torch.Tensor,
                 mask=None) -> torch.Tensor:
    """The masked next-token cross entropy of the final hidden states ``x``
    against ``labels``: :func:`masked_logits` and :func:`token_nll_loss`
    on whole embedding weights, :func:`vocab_nll` over a rank's vocab
    block, reduced the same way."""
    if not vocab_split(cfg, p):
        return token_nll_loss(masked_logits(cfg, p, x), labels, mask)
    return _masked_mean(vocab_nll(cfg, p, x, labels), mask)


def _masked_mean(nll: torch.Tensor, mask) -> torch.Tensor:
    if mask is None:
        return nll.mean()
    nll = nll * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)


def token_nll_loss(logits: torch.Tensor, labels: torch.Tensor,
                   mask=None) -> torch.Tensor:
    """Masked next-token cross entropy of f32 ``logits`` [B, S, V] against
    ``labels`` [B, S]: ``logsumexp - gold`` per token, summed under
    ``mask`` over max(sum(mask), 1), or the mean without one.  The gold
    logit is a gather: on one device it equals the reference's one-hot
    contraction exactly (a sum of zeros and one value), without its
    [B, S, V] mask."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return _masked_mean(logz - gold, mask)


def norm_defs(cfg: ModelConfig) -> dict:
    return {"w": ParamDef((cfg.d_model,), (None,), "ones")}
