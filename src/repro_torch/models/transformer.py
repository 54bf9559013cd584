"""Decoder-only transformer: decode over the paged/pooled KV memory (a port
of the decode path of ``repro.models.transformer``).

Parameters and caches are stacked over layer periods ([n_periods, ...]
leading axis) exactly as in the reference, so the weight bridge and the
page movers see the same layout; where the reference scans over periods,
the port loops over them, taking each period's slice of every stacked
tensor as a view.

This slice serves the dense attention-only family on the ``paged`` and
``pooled`` KV layouts.  The batch layout waits for ROADMAP Queue 1 item 5,
MoE for item 7, SSM/hybrid for item 6 and enc-dec for item 8.
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


def check_layout(cfg: ModelConfig) -> None:
    if cfg.kv_layout not in ("paged", "pooled"):
        raise NotImplementedError(
            f"kv_layout={cfg.kv_layout!r}: the batch layout and full-sequence "
            "prefill are ROADMAP Queue 1 item 5; this slice serves 'paged' "
            "and 'pooled'")


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
# Caches
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, device,
               dtype=None) -> dict:
    """Zero cache: per block position ``{"k_pages", "v_pages"}`` of
    [n_periods, n_pages, slots, Hkv, hd], plus the BlockManager translation
    tables ``cache["vm"]`` shared by every attention layer.  "paged" starts
    from the identity tables (slot b owns frames b*max_pages..), "pooled"
    starts empty."""
    check_supported(cfg)
    check_layout(cfg)
    kv_dtype = torch_dtype(dtype or cfg.kv_dtype or cfg.compute_dtype)
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
# Decode (one token, paged KV layout)
# ---------------------------------------------------------------------------
def _ffn(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    h = L.rms_norm(x, p["ln_mlp"]["w"], cfg.rms_eps)
    return x + L.mlp_block(p["mlp"], h)


def block_decode(cfg: ModelConfig, i: int, p, x: torch.Tensor, entry: dict,
                 lengths: torch.Tensor, vm: dict | None = None,
                 write_mask=None):
    """One layer: x [B, 1, d] -> x'.  The entry's pages (this layer's
    [n_pages, slots, Hkv, hd] views) are updated in place."""
    # imported here: the dispatch layer imports this package's layers
    from repro_torch.parallel.paged_attention import paged_decode_block
    h = L.rms_norm(x, p["ln_mix"]["w"], cfg.rms_eps)
    out, _ = paged_decode_block(cfg, p["attn"], h, entry, lengths, vm,
                                write_mask)
    return _ffn(cfg, p, x + out)


def period_params(params, j: int) -> dict:
    """Period ``j``'s slice of every stacked block parameter, as views."""
    def take(tree):
        return {k: take(v) if not isinstance(v, torch.Tensor) else v[j]
                for k, v in tree.items()}
    return {k: take(v) for k, v in params.items() if k.startswith("b")}


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
    for j in range(cfg.n_periods):
        pp = periods[j] if periods is not None else period_params(params, j)
        for i in range(cfg.layer_period):
            key = f"b{i}"
            entry = {name: t[j] for name, t in cache[key].items()}
            x = block_decode(cfg, i, pp[key], x, entry, lengths, vm,
                             write_mask)
    x = L.rms_norm(x, params["ln_f"]["w"], cfg.rms_eps)
    logits = L.unembed(cfg, params["embed"], x[:, -1]).float()
    if cfg.vocab_padded != cfg.vocab_size:
        pad = torch.arange(cfg.vocab_padded, device=logits.device) \
            >= cfg.vocab_size
        logits = torch.where(pad, L.NEG_INF, logits)
    return logits, cache
