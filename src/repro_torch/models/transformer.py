"""Decoder-only stack: the full-sequence forward, prefill into the batch KV
layout, and decode over the batch, paged and pooled KV layouts (a port of
``repro.models.transformer`` for the dense, MoE, SSM and hybrid families).

Parameters and caches are stacked over layer periods ([n_periods, ...]
leading axis) exactly as in the reference, so the weight bridge and the
page movers see the same layout; where the reference scans over periods,
the port loops over them, taking each period's slice of every stacked
tensor as a view.  Cache layouts (``cfg.kv_layout``):

  "batch"  -- per block ``{"k", "v"}`` of [n_periods, B, Hkv, max_len, hd];
              ``prefill`` fills it, batch-layout decode writes row
              ``lengths - 1`` in place;
  "paged" / "pooled" -- per block ``{"k_pages", "v_pages"}`` plus the
              BlockManager tables ``cache["vm"]``.

A Mamba2 block position keeps per-slot recurrent state in every layout:
``{"conv": [n_periods, B, conv-1, d_inner + 2GN], "ssd": [n_periods, B, H,
N, P] f32}``.

Inputs are token ids (``batch["tokens"]``) or, for the frontend-stub
archs (qwen2-vl-7b), precomputed frame embeddings (``batch["embeds"]``
[B, S, d_model]) in their place.  The encoder-decoder family lives in
:mod:`repro_torch.models.encdec`.

``cfg.remat`` is read where gradients are taken (:func:`stack_apply` with
grad enabled): ``"block"`` and ``"full"`` wrap each period in
``torch.utils.checkpoint`` as the reference wraps ``period_step`` in
``jax.checkpoint``, and ``"dots"`` keeps the matmul outputs and recomputes
the rest (torch's selective checkpoint, the reference's
``checkpoint_dots``); the values do not change.  ``block_barrier``,
``unroll_layers`` and ``maybe_constrain`` are XLA compilation and sharding
controls (optimisation barriers, unrolled scans, sharding constraints): an
eager PyTorch loop has nothing they would change, so the port reads none
of them.  Where the reference lets GSPMD split heads, MLP columns,
experts and vocab over "model", the port's tensor-parallel split form
holds a rank's shards of the weights (:meth:`Model.shard
<repro_torch.models.model.Model.shard>`) and every block computes on what
it holds (:mod:`repro_torch.models.layers`, :mod:`repro_torch.models.ssm`);
the batch cache then holds the rank's KV heads, and the Mamba2 states its
SSM heads' (:func:`local_widths`).
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.device import torch_dtype
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import mesh_ctx
from repro_torch.tree import unstack


#: the frontend stubs: their inputs are precomputed frame embeddings
FRONTENDS = (None, "vision_stub", "audio_stub")


def is_encdec(cfg: ModelConfig) -> bool:
    """Whether ``cfg`` is the encoder-decoder family (the reference's
    ``Model.defs`` test)."""
    return cfg.family == "encdec" or bool(cfg.n_encoder_layers)


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError, naming it, for what the port does not
    serve: a frontend other than the reference's stubs, and enc-dec on a
    paged or pooled KV layout (the reference serves enc-dec on the batch
    layout only: its decode has no masked-write path)."""
    if cfg.frontend not in FRONTENDS:
        raise NotImplementedError(f"frontend {cfg.frontend!r}: the port has "
                                  f"the stubs {FRONTENDS[1:]} only")
    if is_encdec(cfg) and cfg.kv_layout != "batch":
        raise NotImplementedError(
            f"enc-dec on the {cfg.kv_layout!r} KV layout: the reference "
            "serves enc-dec on the batch layout only")


def _check_decoder(cfg: ModelConfig) -> None:
    check_supported(cfg)
    if is_encdec(cfg):
        raise ValueError(f"{cfg.name} is an encoder-decoder: use "
                         "repro_torch.models.encdec")


# ---------------------------------------------------------------------------
# Parameter tables
# ---------------------------------------------------------------------------
def block_defs(cfg: ModelConfig, i: int) -> dict:
    d: dict = {"ln_mix": L.norm_defs(cfg)}
    if cfg.layer_kind(i) == "attn":
        d["attn"] = L.attention_defs(cfg)
    else:
        d["mamba"] = S.ssm_defs(cfg)
    if cfg.layer_has_mlp(i):
        d["ln_mlp"] = L.norm_defs(cfg)
        if cfg.layer_has_moe(i):
            d["moe"] = M.moe_defs(cfg)
        else:
            d["mlp"] = L.mlp_defs(cfg)
    return d


def decoder_defs(cfg: ModelConfig) -> dict:
    _check_decoder(cfg)
    defs: dict = {"embed": L.embedding_defs(cfg), "ln_f": L.norm_defs(cfg)}
    for i in range(cfg.layer_period):
        defs[f"b{i}"] = L.stack_defs(block_defs(cfg, i), cfg.n_periods)
    return defs


# ---------------------------------------------------------------------------
# Blocks and the full stack (forward without cache)
# ---------------------------------------------------------------------------
def _mixer(cfg: ModelConfig, i: int, p, x: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    h = L.rms_norm(x, p["ln_mix"]["w"], cfg.rms_eps)
    if cfg.layer_kind(i) == "attn":
        return x + L.attention_block(cfg, p["attn"], h, positions)
    return x + S.ssm_block(cfg, p["mamba"], h)


def _ffn(cfg: ModelConfig, i: int, p, x: torch.Tensor) -> torch.Tensor:
    if not cfg.layer_has_mlp(i):
        return x
    h = L.rms_norm(x, p["ln_mlp"]["w"], cfg.rms_eps)
    if cfg.layer_has_moe(i):
        return x + M.moe_block(cfg, p["moe"], h)
    return x + L.mlp_block(p["mlp"], h, cfg.d_ff)


def block_apply(cfg: ModelConfig, i: int, p, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    return _ffn(cfg, i, p, _mixer(cfg, i, p, x, positions))


def period_views(cfg: ModelConfig, params) -> list[dict]:
    """Each period's slice of every stacked block parameter, as views."""
    return unstack({k: v for k, v in params.items() if k.startswith("b")},
                   cfg.n_periods)


def _periods(cfg: ModelConfig, params, periods):
    return periods if periods is not None else period_views(cfg, params)


def _dots_policy(ctx, func, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    if func in (aten.mm.default, aten.bmm.default, aten.addmm.default,
                aten.baddbmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat(cfg: ModelConfig, fn):
    """``fn`` under ``cfg.remat`` while gradients are being recorded: the
    whole call recomputed in the backward pass ("block", "full"), or all
    of it but its matmul outputs ("dots"); ``fn`` itself otherwise."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat not in ("block", "full", "dots"):
        raise ValueError(f"unknown remat {cfg.remat!r}")
    from torch.utils import checkpoint as ckpt
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = lambda: ckpt.create_selective_checkpoint_contexts(
            _dots_policy)
    return lambda *args: ckpt.checkpoint(fn, *args, use_reentrant=False,
                                         **kw)


def stack_apply(cfg: ModelConfig, params, x: torch.Tensor,
                positions: torch.Tensor, periods=None) -> torch.Tensor:
    def period_step(h, pp):
        for i in range(cfg.layer_period):
            h = block_apply(cfg, i, pp[f"b{i}"], h, positions)
        return h

    step = remat(cfg, period_step)
    for pp in _periods(cfg, params, periods):
        x = step(x, pp)
    return x


def _embed(cfg: ModelConfig, params, batch: dict) -> torch.Tensor:
    """The stack's input: ``batch["embeds"]`` (frame embeddings) where
    given, else the embedded ``batch["tokens"]``, in the compute dtype."""
    if "embeds" in batch:
        x = batch["embeds"]
    else:
        x = L.embed_tokens(cfg, params["embed"], batch["tokens"])
    return x.to(torch_dtype(cfg.compute_dtype))


def _positions(x: torch.Tensor) -> torch.Tensor:
    b, s = x.shape[:2]
    return torch.arange(s, device=x.device).expand(b, s)


def _last_logits(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    """Final norm, unembed of the last position, padded vocab masked."""
    x = L.rms_norm(x, params["ln_f"]["w"], cfg.rms_eps)
    return L.masked_logits(cfg, params["embed"], x[:, -1])


def forward(cfg: ModelConfig, params, batch: dict, periods=None):
    """Embed (or take ``batch["embeds"]``) -> stack -> final norm.
    Returns hidden states [B, S, d]."""
    _check_decoder(cfg)
    x = _embed(cfg, params, batch)
    x = stack_apply(cfg, params, x, _positions(x), periods)
    return L.rms_norm(x, params["ln_f"]["w"], cfg.rms_eps)


def lm_loss(cfg: ModelConfig, params, batch: dict,
            periods=None) -> torch.Tensor:
    """Masked next-token cross entropy (labels already shifted by the data
    pipeline), softmax in f32 with the padded vocab at ``NEG_INF``
    (:func:`repro_torch.models.layers.lm_head_loss`: over a rank's vocab
    block on the split form).  To take gradients pass no ``periods``:
    views made without grad carry none."""
    x = forward(cfg, params, batch, periods)
    return L.lm_head_loss(cfg, params["embed"], x, batch["labels"],
                          batch.get("mask"))


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------
def _kv_shards(n_pages: int) -> int:
    """The mesh context's kv shards (1 without one); a pool of
    ``n_pages`` must split evenly over them."""
    ctx = mesh_ctx.get_context()
    n = 1 if ctx is None else ctx.n_kv_shards
    if n_pages % n:
        raise ValueError(f"a pool of {n_pages} pages does not split over "
                         f"{n} kv shards")
    return n


def local_widths(cfg: ModelConfig, params) -> dict:
    """The cache widths the weights of ``params`` (stacked or a period's
    views) hold, as :func:`init_cache` takes them: ``n_kv_heads`` of the
    attention blocks, and of the Mamba2 blocks ``conv_ch`` (x then B then
    C channels) and ``ssm_heads`` -- the config's, or a tensor-parallel
    rank's shard of them; the config's for a kind of block ``params``
    does not have."""
    out = {}
    for i in range(cfg.layer_period):
        block = params[f"b{i}"]
        if "attn" in block:
            out["n_kv_heads"] = L.local_heads(cfg, block["attn"])[1]
        if "mamba" in block:
            di, h, g = S.local_widths(cfg, block["mamba"])
            out.update(conv_ch=di + 2 * g * cfg.ssm_state, ssm_heads=h)
    return out


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, device,
               dtype=None, widths: dict | None = None) -> dict:
    """Zero cache.  Attention block positions: batch layout ``{"k", "v"}``
    of [n_periods, B, Hkv, max_len, hd] (``widths["n_kv_heads"]``, a
    tensor-parallel rank's KV heads (:func:`local_widths`), in place of
    ``cfg.n_kv_heads`` where given: the paged pages hold every KV head,
    replicated over tp); paged layouts ``{"k_pages",
    "v_pages"}`` of [n_periods, n_pages, slots, Hkv, hd], plus the
    BlockManager translation tables ``cache["vm"]`` shared by every
    attention layer (only when there is one); "paged" starts from the
    identity tables (slot b owns frames b*max_pages..), "pooled" starts
    empty.  Under a mesh context (:mod:`repro_torch.parallel.mesh_ctx`)
    the pages are this rank's block, ``n_pages / n_kv_shards`` of them,
    and the tables stay global.  Mamba2 block positions: ``conv``
    [n_periods, B, conv-1, d_inner + 2GN] in the compute dtype and ``ssd``
    [n_periods, B, H, N, P] in f32 (a rank's ``widths["conv_ch"]`` and
    ``widths["ssm_heads"]`` where given)."""
    _check_decoder(cfg)
    widths = widths or {}
    kv_dtype = torch_dtype(dtype or cfg.kv_dtype or cfg.compute_dtype)
    state_dtype = torch_dtype(dtype or cfg.compute_dtype)
    if cfg.kv_layout not in ("batch", "paged", "pooled"):
        raise ValueError(f"unknown kv_layout {cfg.kv_layout!r}")
    paged = cfg.kv_layout in ("paged", "pooled")
    if paged:
        slots = cfg.kv_page_slots
        max_pages = -(-max_len // slots)
        if cfg.kv_layout == "pooled":
            n_pages = cfg.kv_pool_pages or batch_size * max_pages
        else:
            n_pages = batch_size * max_pages
        names = ("k_pages", "v_pages")
        shape = (cfg.n_periods, n_pages // _kv_shards(n_pages), slots,
                 cfg.n_kv_heads, cfg.hd)
    else:
        names = ("k", "v")
        shape = (cfg.n_periods, batch_size,
                 widths.get("n_kv_heads", cfg.n_kv_heads), max_len, cfg.hd)
    cache: dict = {}
    for i in range(cfg.layer_period):
        if cfg.layer_kind(i) == "attn":
            cache[f"b{i}"] = {name: torch.zeros(shape, dtype=kv_dtype,
                                                device=device)
                              for name in names}
        else:
            conv_ch = widths.get("conv_ch", cfg.d_inner + 2 * cfg.ssm_groups
                                 * cfg.ssm_state)
            cache[f"b{i}"] = {
                "conv": torch.zeros((cfg.n_periods, batch_size,
                                     cfg.ssm_conv - 1, conv_ch),
                                    dtype=state_dtype, device=device),
                "ssd": torch.zeros((cfg.n_periods, batch_size,
                                    widths.get("ssm_heads", cfg.ssm_heads),
                                    cfg.ssm_state,
                                    cfg.ssm_head_dim), dtype=torch.float32,
                                   device=device)}
    if not paged or all(cfg.layer_kind(i) != "attn"
                        for i in range(cfg.layer_period)):
        return cache
    i32 = dict(dtype=torch.int32, device=device)
    if cfg.kv_layout == "pooled":
        block_table = torch.full((batch_size, max_pages), -1, **i32)
        frame_lpage = torch.zeros((n_pages,), **i32)
    else:
        block_table = torch.arange(n_pages, **i32).reshape(batch_size,
                                                           max_pages)
        frame_lpage = torch.arange(max_pages, **i32).repeat(batch_size)
    cache["vm"] = {
        "block_table": block_table,
        "frame_lpage": frame_lpage,
        "frame_ro": torch.zeros((n_pages,), dtype=torch.bool, device=device),
    }
    return cache


cache_spec = functools.partial(init_cache, device="meta")


# ---------------------------------------------------------------------------
# Prefill (batch KV layout)
# ---------------------------------------------------------------------------
def block_prefill(cfg: ModelConfig, i: int, p, x: torch.Tensor,
                  positions: torch.Tensor, entry: dict) -> torch.Tensor:
    """Like :func:`block_apply`, and writes this block's cache into
    ``entry`` (this period's views of the zeroed cache).  Attention: K/V of
    the S prompt positions into ``k``/``v`` [B, Hkv, max_len, hd]
    (positions >= S stay zero, the reference's pad).  Mamba2: the conv
    tail into ``conv`` in the compute dtype and the final SSD state into
    ``ssd`` in f32."""
    h = L.rms_norm(x, p["ln_mix"]["w"], cfg.rms_eps)
    b, s, _ = x.shape
    if cfg.layer_kind(i) == "attn":
        q, k, v = L.project_qkv(cfg, p["attn"], h, positions)
        out = L.full_attention(cfg, q, k, v, causal=True, window=cfg.window)
        x = x + L.attention_out(cfg, p["attn"],
                                out.transpose(1, 2).reshape(b, s, -1))
        entry["k"][:, :, :s] = L.cast_kv(k, entry["k"].dtype)
        entry["v"][:, :, :s] = L.cast_kv(v, entry["v"].dtype)
    else:
        out, (conv, ssd) = S.ssm_block(cfg, p["mamba"], h, return_state=True)
        x = x + out
        entry["conv"].copy_(conv)
        entry["ssd"].copy_(ssd)
    return _ffn(cfg, i, p, x)


def prefill(cfg: ModelConfig, params, batch: dict, max_len: int,
            periods=None):
    """Run the prompt, return (last-position logits [B, vocab_padded] f32,
    cache) with the cache in the batch KV layout: per attention block
    ``{"k", "v"}`` of [n_periods, B, Hkv, max_len, hd] (the KV heads the
    weights hold) in the compute dtype,
    as the reference pads and casts it; per Mamba2 block ``{"conv",
    "ssd"}`` as :func:`init_cache` lays them out.  The prompt is
    ``batch["tokens"]`` or ``batch["embeds"]``."""
    _check_decoder(cfg)
    x = _embed(cfg, params, batch)
    b, s = x.shape[:2]
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens exceeds max_len {max_len}")
    positions = _positions(x)
    cache = init_cache(dataclasses.replace(cfg, kv_layout="batch"), b,
                       max_len, x.device, x.dtype,
                       widths=local_widths(cfg, params))
    for j, pp in enumerate(_periods(cfg, params, periods)):
        for i in range(cfg.layer_period):
            entry = {name: t[j] for name, t in cache[f"b{i}"].items()}
            x = block_prefill(cfg, i, pp[f"b{i}"], x, positions, entry)
    return _last_logits(cfg, params, x), cache


# ---------------------------------------------------------------------------
# Decode (one token; batch or paged KV layout)
# ---------------------------------------------------------------------------
def block_decode(cfg: ModelConfig, i: int, p, x: torch.Tensor, entry: dict,
                 lengths: torch.Tensor, vm: dict | None = None,
                 write_mask=None):
    """One layer: x [B, 1, d] -> x'.  The entry (this layer's views of the
    cache: batch-layout ``k``/``v``, paged ``k_pages``/``v_pages`` or
    Mamba2 ``conv``/``ssd``) is updated in place; rows ``write_mask`` turns
    off keep their cache, the reference's ``_mask_entry``."""
    h = L.rms_norm(x, p["ln_mix"]["w"], cfg.rms_eps)
    if cfg.layer_kind(i) != "attn":
        out, conv, ssd = S.ssm_decode_step(cfg, p["mamba"], h, entry["conv"],
                                           entry["ssd"])
        for name, new in (("conv", conv), ("ssd", ssd)):
            if write_mask is not None:
                keep = write_mask.view((-1,) + (1,) * (new.dim() - 1))
                new = torch.where(keep, new, entry[name])
            entry[name].copy_(new)
        return _ffn(cfg, i, p, x + out)
    if cfg.kv_layout in ("paged", "pooled"):
        # imported here: the dispatch layer imports this package's layers
        from repro_torch.parallel.paged_attention import paged_decode_block
        out, _ = paged_decode_block(cfg, p["attn"], h, entry, lengths, vm,
                                    write_mask)
    else:
        out, _, _ = L.decode_attention_block(cfg, p["attn"], h, entry["k"],
                                             entry["v"], lengths, write_mask)
    return _ffn(cfg, i, p, x + out)


def decode_step(cfg: ModelConfig, params, tokens: torch.Tensor, cache: dict,
                lengths: torch.Tensor, write_mask=None, periods=None):
    """One decode step for every sequence.

    tokens: [B, 1] (the tokens just sampled); lengths: [B] int32 valid
    length INCLUDING these tokens.  Returns (logits [B, vocab_padded] f32,
    cache); the cache's pages are updated in place.  ``periods`` may pass
    precomputed :func:`period_views` slices (one per period).

    write_mask: optional [B] bool -- sequences masked off keep their KV
    unchanged (the engine prefills one slot through the shared batch)."""
    x = L.embed_tokens(cfg, params["embed"], tokens).to(
        torch_dtype(cfg.compute_dtype))
    vm = cache.get("vm")
    for j, pp in enumerate(_periods(cfg, params, periods)):
        for i in range(cfg.layer_period):
            key = f"b{i}"
            entry = {name: t[j] for name, t in cache[key].items()}
            x = block_decode(cfg, i, pp[key], x, entry, lengths, vm,
                             write_mask)
    return _last_logits(cfg, params, x), cache
