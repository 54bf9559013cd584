"""Decoder-only transformer: the full-sequence forward, prefill into the
batch KV layout, and decode over the batch, paged and pooled KV layouts (a
port of ``repro.models.transformer`` for the dense family).

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

The reference's ``remat``, ``block_barrier``, ``unroll_layers`` and
``maybe_constrain`` are XLA compilation and sharding controls (rematerial-
isation, optimisation barriers, unrolled scans, sharding constraints): an
eager PyTorch loop has nothing they would change, so the port reads none
of them.  ``lm_loss`` waits for the training slice (ROADMAP Queue 1 item
10), MoE for item 7, SSM/hybrid for item 6 and enc-dec for item 8.
"""
from __future__ import annotations

import torch

from repro_torch.device import torch_dtype
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError, naming the ROADMAP item, for what this
    slice of the port does not serve yet."""
    if cfg.family == "encdec" or cfg.n_encoder_layers:
        raise NotImplementedError("enc-dec models: ROADMAP Queue 1 item 8")
    if cfg.frontend is not None:
        raise NotImplementedError("vision/audio frontends: ROADMAP Queue 1 item 8")
    if any(cfg.layer_kind(i) != "attn" for i in range(cfg.layer_period)):
        raise NotImplementedError("SSM and hybrid models: ROADMAP Queue 1 item 6")
    if cfg.n_experts:
        raise NotImplementedError("MoE models: ROADMAP Queue 1 item 7")


# ---------------------------------------------------------------------------
# Parameter tables
# ---------------------------------------------------------------------------
def block_defs(cfg: ModelConfig, i: int) -> dict:
    return {"ln_mix": L.norm_defs(cfg), "attn": L.attention_defs(cfg),
            "ln_mlp": L.norm_defs(cfg), "mlp": L.mlp_defs(cfg)}


def decoder_defs(cfg: ModelConfig) -> dict:
    check_supported(cfg)
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
    return x + L.attention_block(cfg, p["attn"], h, positions)


def _ffn(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    h = L.rms_norm(x, p["ln_mlp"]["w"], cfg.rms_eps)
    return x + L.mlp_block(p["mlp"], h)


def block_apply(cfg: ModelConfig, i: int, p, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    return _ffn(cfg, p, _mixer(cfg, i, p, x, positions))


def period_params(params, j: int) -> dict:
    """Period ``j``'s slice of every stacked block parameter, as views."""
    def take(tree):
        return {k: take(v) if not isinstance(v, torch.Tensor) else v[j]
                for k, v in tree.items()}
    return {k: take(v) for k, v in params.items() if k.startswith("b")}


def _periods(cfg: ModelConfig, params, periods):
    return periods if periods is not None else [
        period_params(params, j) for j in range(cfg.n_periods)]


def stack_apply(cfg: ModelConfig, params, x: torch.Tensor,
                positions: torch.Tensor, periods=None) -> torch.Tensor:
    for pp in _periods(cfg, params, periods):
        for i in range(cfg.layer_period):
            x = block_apply(cfg, i, pp[f"b{i}"], x, positions)
    return x


def _embed(cfg: ModelConfig, params, batch: dict) -> torch.Tensor:
    return L.embed_tokens(cfg, params["embed"], batch["tokens"]).to(
        torch_dtype(cfg.compute_dtype))


def _positions(x: torch.Tensor) -> torch.Tensor:
    b, s = x.shape[:2]
    return torch.arange(s, device=x.device).expand(b, s)


def _last_logits(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    """Final norm, unembed of the last position, padded vocab masked."""
    x = L.rms_norm(x, params["ln_f"]["w"], cfg.rms_eps)
    logits = L.unembed(cfg, params["embed"], x[:, -1]).float()
    if cfg.vocab_padded != cfg.vocab_size:
        pad = torch.arange(cfg.vocab_padded, device=logits.device) \
            >= cfg.vocab_size
        logits = torch.where(pad, L.NEG_INF, logits)
    return logits


def forward(cfg: ModelConfig, params, batch: dict, periods=None):
    """Embed -> stack -> final norm.  Returns hidden states [B, S, d]."""
    check_supported(cfg)
    x = _embed(cfg, params, batch)
    x = stack_apply(cfg, params, x, _positions(x), periods)
    return L.rms_norm(x, params["ln_f"]["w"], cfg.rms_eps)


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, device,
               dtype=None) -> dict:
    """Zero cache.  Batch layout: per block position ``{"k", "v"}`` of
    [n_periods, B, Hkv, max_len, hd].  Paged layouts: per block position
    ``{"k_pages", "v_pages"}`` of [n_periods, n_pages, slots, Hkv, hd], plus
    the BlockManager translation tables ``cache["vm"]`` shared by every
    attention layer; "paged" starts from the identity tables (slot b owns
    frames b*max_pages..), "pooled" starts empty."""
    check_supported(cfg)
    kv_dtype = torch_dtype(dtype or cfg.kv_dtype or cfg.compute_dtype)
    if cfg.kv_layout == "batch":
        shape = (cfg.n_periods, batch_size, cfg.n_kv_heads, max_len, cfg.hd)
        return {f"b{i}": {"k": torch.zeros(shape, dtype=kv_dtype,
                                           device=device),
                          "v": torch.zeros(shape, dtype=kv_dtype,
                                           device=device)}
                for i in range(cfg.layer_period)}
    if cfg.kv_layout not in ("paged", "pooled"):
        raise ValueError(f"unknown kv_layout {cfg.kv_layout!r}")
    slots = cfg.kv_page_slots
    max_pages = -(-max_len // slots)
    if cfg.kv_layout == "pooled":
        n_pages = cfg.kv_pool_pages or batch_size * max_pages
    else:
        n_pages = batch_size * max_pages
    shape = (cfg.n_periods, n_pages, slots, cfg.n_kv_heads, cfg.hd)
    cache: dict = {}
    for i in range(cfg.layer_period):
        cache[f"b{i}"] = {
            "k_pages": torch.zeros(shape, dtype=kv_dtype, device=device),
            "v_pages": torch.zeros(shape, dtype=kv_dtype, device=device),
        }
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


# ---------------------------------------------------------------------------
# Prefill (batch KV layout)
# ---------------------------------------------------------------------------
def block_prefill(cfg: ModelConfig, i: int, p, x: torch.Tensor,
                  positions: torch.Tensor, k_out: torch.Tensor,
                  v_out: torch.Tensor) -> torch.Tensor:
    """Like :func:`block_apply`, and writes this block's K/V for the S
    prompt positions into ``k_out``/``v_out`` ([B, Hkv, max_len, hd] views
    of the zeroed cache; positions >= S stay zero, the reference's pad)."""
    h = L.rms_norm(x, p["ln_mix"]["w"], cfg.rms_eps)
    b, s, _ = x.shape
    q, k, v = L.project_qkv(cfg, p["attn"], h, positions)
    out = L.full_attention(cfg, q, k, v, causal=True, window=cfg.window)
    out = out.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.hd)
    x = x + out @ p["attn"]["wo"]
    k_out[:, :, :s] = k
    v_out[:, :, :s] = v
    return _ffn(cfg, p, x)


def prefill(cfg: ModelConfig, params, batch: dict, max_len: int,
            periods=None):
    """Run the prompt, return (last-position logits [B, vocab_padded] f32,
    cache) with the cache in the batch KV layout (per block ``{"k", "v"}``
    of [n_periods, B, Hkv, max_len, hd] in the compute dtype, as the
    reference pads and casts it)."""
    check_supported(cfg)
    x = _embed(cfg, params, batch)
    b, s = x.shape[:2]
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens exceeds max_len {max_len}")
    positions = _positions(x)
    shape = (cfg.n_periods, b, cfg.n_kv_heads, max_len, cfg.hd)
    cache = {f"b{i}": {name: torch.zeros(shape, dtype=x.dtype,
                                         device=x.device)
                       for name in ("k", "v")}
             for i in range(cfg.layer_period)}
    for j, pp in enumerate(_periods(cfg, params, periods)):
        for i in range(cfg.layer_period):
            e = cache[f"b{i}"]
            x = block_prefill(cfg, i, pp[f"b{i}"], x, positions,
                              e["k"][j], e["v"][j])
    return _last_logits(cfg, params, x), cache


# ---------------------------------------------------------------------------
# Decode (one token; batch or paged KV layout)
# ---------------------------------------------------------------------------
def block_decode(cfg: ModelConfig, i: int, p, x: torch.Tensor, entry: dict,
                 lengths: torch.Tensor, vm: dict | None = None,
                 write_mask=None):
    """One layer: x [B, 1, d] -> x'.  The entry (this layer's views of the
    cache: batch-layout ``k``/``v`` or paged ``k_pages``/``v_pages``) is
    updated in place; rows ``write_mask`` turns off keep their cache, the
    reference's ``_mask_entry``."""
    h = L.rms_norm(x, p["ln_mix"]["w"], cfg.rms_eps)
    if cfg.kv_layout in ("paged", "pooled"):
        # imported here: the dispatch layer imports this package's layers
        from repro_torch.parallel.paged_attention import paged_decode_block
        out, _ = paged_decode_block(cfg, p["attn"], h, entry, lengths, vm,
                                    write_mask)
    else:
        out, _, _ = L.decode_attention_block(cfg, p["attn"], h, entry["k"],
                                             entry["v"], lengths, write_mask)
    return _ffn(cfg, p, x + out)


def decode_step(cfg: ModelConfig, params, tokens: torch.Tensor, cache: dict,
                lengths: torch.Tensor, write_mask=None, periods=None):
    """One decode step for every sequence.

    tokens: [B, 1] (the tokens just sampled); lengths: [B] int32 valid
    length INCLUDING these tokens.  Returns (logits [B, vocab_padded] f32,
    cache); the cache's pages are updated in place.  ``periods`` may pass
    precomputed :func:`period_params` slices (one per period).

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
