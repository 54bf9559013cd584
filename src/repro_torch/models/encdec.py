"""Encoder-decoder transformer (the seamless-m4t backbone): a port of
``repro.models.encdec``.

The audio frontend is a stub: the encoder takes precomputed frame
embeddings [B, S_src, d_model].  The decoder is a causal LM with
cross-attention to the encoder's states.  Parameters are stacked over
layers (``enc`` [n_encoder_layers, ...], ``dec`` [n_layers, ...]) exactly
as in the reference, so the weight bridge loads its tree as it is; the
port loops over the layers where the reference scans, taking each layer's
slice of the stacked tensors as a view.  ``layers`` may pass those views
precomputed (:func:`layer_views`); to take gradients pass none, since
views made without grad carry none.  ``cfg.remat`` "block" and "full" wrap
each layer in ``torch.utils.checkpoint`` while gradients are recorded, as
the reference wraps its layer step in ``jax.checkpoint``.

Serving: :func:`prepare_cross_cache` runs the encoder once and fills the
cross-attention K/V; :func:`decode_step` then takes one decoder token for
every sequence on the batch KV layout.  The reference does not serve
enc-dec through its engine, and neither does the port.  A tensor-parallel
rank's split form (:meth:`repro_torch.models.model.Model.shard`) holds
its heads of the encoder's, the self- and the cross-attention, its MLP
columns and its vocab block; its caches hold its KV heads
(:func:`local_kv_heads`), and a decoder layer sums three row-parallel
products over tp (self- and cross-attention ``wo``, ``w_down``).
"""
from __future__ import annotations

import torch

from repro_torch.device import torch_dtype
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.tree import unstack


def encoder_layer_defs(cfg: ModelConfig) -> dict:
    return {
        "ln1": L.norm_defs(cfg), "attn": L.attention_defs(cfg),
        "ln2": L.norm_defs(cfg), "mlp": L.mlp_defs(cfg),
    }


def decoder_layer_defs(cfg: ModelConfig) -> dict:
    return {
        "ln1": L.norm_defs(cfg), "self_attn": L.attention_defs(cfg),
        "lnx": L.norm_defs(cfg), "cross_attn": L.attention_defs(cfg),
        "ln2": L.norm_defs(cfg), "mlp": L.mlp_defs(cfg),
    }


def encdec_defs(cfg: ModelConfig) -> dict:
    T.check_supported(cfg)
    return {
        "embed": L.embedding_defs(cfg),
        "enc": L.stack_defs(encoder_layer_defs(cfg), cfg.n_encoder_layers),
        "dec": L.stack_defs(decoder_layer_defs(cfg), cfg.n_layers),
        "ln_enc": L.norm_defs(cfg),
        "ln_f": L.norm_defs(cfg),
    }


def layer_views(cfg: ModelConfig, params) -> dict:
    """Each encoder and decoder layer's slice of the stacked weights, as
    views: ``{"enc": [...], "dec": [...]}``."""
    return {"enc": unstack(params["enc"], cfg.n_encoder_layers),
            "dec": unstack(params["dec"], cfg.n_layers)}


def _layers(cfg: ModelConfig, params, layers, name: str) -> list:
    return (layers or layer_views(cfg, params))[name]


def _remat(cfg: ModelConfig, fn):
    # the reference checkpoints enc-dec layers for "block" and "full" only
    return T.remat(cfg, fn) if cfg.remat in ("block", "full") else fn


def encode(cfg: ModelConfig, params, embeds: torch.Tensor,
           layers=None) -> torch.Tensor:
    """Frame embeddings [B, S_src, d] -> encoder states: non-causal
    self-attention over positions ``0..S_src-1``, then the final norm."""
    x = embeds.to(torch_dtype(cfg.compute_dtype))
    positions = T._positions(x)

    def step(h, p):
        a = L.rms_norm(h, p["ln1"]["w"], cfg.rms_eps)
        h = h + L.attention_block(cfg, p["attn"], a, positions, causal=False)
        m = L.rms_norm(h, p["ln2"]["w"], cfg.rms_eps)
        return h + L.mlp_block(p["mlp"], m, cfg.d_ff)

    step = _remat(cfg, step)
    for p in _layers(cfg, params, layers, "enc"):
        x = step(x, p)
    return L.rms_norm(x, params["ln_enc"]["w"], cfg.rms_eps)


def decode_train(cfg: ModelConfig, params, tokens: torch.Tensor,
                 enc_out: torch.Tensor, layers=None) -> torch.Tensor:
    """Teacher-forced decoder pass -> hidden states [B, S_tgt, d]."""
    x = L.embed_tokens(cfg, params["embed"], tokens).to(
        torch_dtype(cfg.compute_dtype))
    positions = T._positions(x)

    def step(h, p):
        a = L.rms_norm(h, p["ln1"]["w"], cfg.rms_eps)
        h = h + L.attention_block(cfg, p["self_attn"], a, positions,
                                  causal=True)
        c = L.rms_norm(h, p["lnx"]["w"], cfg.rms_eps)
        kv = L.encode_kv(cfg, p["cross_attn"], enc_out)
        h = h + L.cross_attention_block(cfg, p["cross_attn"], c, kv)
        m = L.rms_norm(h, p["ln2"]["w"], cfg.rms_eps)
        return h + L.mlp_block(p["mlp"], m, cfg.d_ff)

    step = _remat(cfg, step)
    for p in _layers(cfg, params, layers, "dec"):
        x = step(x, p)
    return L.rms_norm(x, params["ln_f"]["w"], cfg.rms_eps)


def lm_loss(cfg: ModelConfig, params, batch: dict,
            layers=None) -> torch.Tensor:
    """Masked next-token cross entropy of the decoder over
    ``batch["tokens"]`` given ``batch["embeds"]``, as
    :func:`repro_torch.models.transformer.lm_loss` takes it."""
    enc_out = encode(cfg, params, batch["embeds"], layers)
    x = decode_train(cfg, params, batch["tokens"], enc_out, layers)
    return L.lm_head_loss(cfg, params["embed"], x, batch["labels"],
                          batch.get("mask"))


# ---------------------------------------------------------------------------
# Serving: cached cross-attention K/V + self-attention KV cache
# ---------------------------------------------------------------------------
def local_kv_heads(cfg: ModelConfig, params) -> int:
    """The KV heads the decoder's attention weights hold: the config's, or
    a tensor-parallel rank's whole-head shard of them."""
    return L.local_heads(cfg, params["dec"]["self_attn"])[1]


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               src_len: int, device, dtype=None,
               n_kv_heads: int | None = None) -> dict:
    """Zero cache: self-attention ``k``/``v`` [n_layers, B, Hkv, max_len,
    hd] and cross-attention ``xk``/``xv`` [n_layers, B, Hkv, src_len, hd],
    in the compute dtype unless ``dtype`` is given; ``n_kv_heads`` (a
    tensor-parallel rank's, :func:`local_kv_heads`) in place of
    ``cfg.n_kv_heads`` where given."""
    T.check_supported(cfg)
    dt = torch_dtype(dtype or cfg.compute_dtype)
    nl, hkv, hd = cfg.n_layers, n_kv_heads or cfg.n_kv_heads, cfg.hd

    def zeros(s):
        return torch.zeros((nl, batch_size, hkv, s, hd), dtype=dt,
                           device=device)
    return {"k": zeros(max_len), "v": zeros(max_len),
            "xk": zeros(src_len), "xv": zeros(src_len)}


def prepare_cross_cache(cfg: ModelConfig, params, embeds: torch.Tensor,
                        cache: dict, layers=None) -> dict:
    """Run the encoder once and fill the cross-attention K/V: returns the
    cache with ``xk``/``xv`` [n_layers, B, Hkv, S_src, hd] of ``embeds``'
    length, in the dtype the cache had."""
    enc_out = encode(cfg, params, embeds, layers)
    ks, vs = zip(*(L.encode_kv(cfg, p["cross_attn"], enc_out)
                   for p in _layers(cfg, params, layers, "dec")))
    return dict(cache, xk=L.cast_kv(torch.stack(ks), cache["xk"].dtype),
                xv=L.cast_kv(torch.stack(vs), cache["xv"].dtype))


def decode_step(cfg: ModelConfig, params, tokens: torch.Tensor, cache: dict,
                lengths: torch.Tensor, layers=None):
    """One decoder token for every sequence (cross K/V already prepared).

    tokens: [B, 1]; lengths: [B] int32 valid length INCLUDING these tokens.
    Returns (logits [B, vocab_padded] f32, cache); the self-attention
    ``k``/``v`` are written in place at ``lengths - 1``."""
    x = L.embed_tokens(cfg, params["embed"], tokens).to(
        torch_dtype(cfg.compute_dtype))
    for j, p in enumerate(_layers(cfg, params, layers, "dec")):
        a = L.rms_norm(x, p["ln1"]["w"], cfg.rms_eps)
        out, _, _ = L.decode_attention_block(
            cfg, p["self_attn"], a, cache["k"][j], cache["v"][j], lengths)
        x = x + out
        c = L.rms_norm(x, p["lnx"]["w"], cfg.rms_eps)
        x = x + L.cross_attention_block(cfg, p["cross_attn"], c,
                                        (cache["xk"][j], cache["xv"][j]))
        m = L.rms_norm(x, p["ln2"]["w"], cfg.rms_eps)
        x = x + L.mlp_block(p["mlp"], m, cfg.d_ff)
    x = L.rms_norm(x, params["ln_f"]["w"], cfg.rms_eps)
    return L.masked_logits(cfg, params["embed"], x[:, -1]), cache
