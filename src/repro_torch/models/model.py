"""Model facade: an ``nn.Module`` holding the weights of one model of the
registry, with its loss and its serving paths (a port of
``repro.models.model``).

Weights are drawn from an explicit ``torch.Generator`` on the model's device
with the reference's distributions; they are stacked over layer periods
(decoders) or layers (enc-dec) exactly as the reference's param pytree, so
:func:`repro_torch.weights.from_jax_params` can load that pytree one tensor
at a time.  Parameters are built with ``requires_grad=False``: forward,
prefill and decode run without gradients.  Training turns them on
(``model.params.requires_grad_(True)``, as
:class:`repro_torch.train.trainer.Trainer` does) and takes :meth:`loss`,
which indexes the stacked weights afresh with grad on; an optimizer step
writes the parameters in place, so the cached serving views stay valid.

:meth:`Model.shard` gives the tensor-parallel split form of every arch: a
model over one rank's shards of the weights under the installed mesh
context (its attention heads, MLP columns, experts, SSM heads and vocab
block; ``tp_only``), which serves through the same entry points with one
collective after each row-parallel product and one in each Mamba2 gated
norm, and trains (:class:`repro_torch.train.trainer.Trainer` on a mesh
with tp > 1): its loss and gradients are taken on the rank's shards,
which :meth:`Model.whole_tree` gathers whole.  A model of whole weights
under a context computes on them whole, as before.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models import encdec as E
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import mesh_ctx
from repro_torch.parallel.sharding import split_cuts, tp_shard_params
from repro_torch.tree import flatten, unflatten


def defs_for(cfg: ModelConfig) -> dict:
    """The parameter tables of ``cfg``: enc-dec or decoder."""
    if T.is_encdec(cfg):
        return E.encdec_defs(cfg)
    return T.decoder_defs(cfg)


def _build(defs: dict, gen: torch.Generator, dtype, device) -> nn.Module:
    """Nested ParamDef dicts -> ModuleDicts of ParameterDicts (sorted key
    order, as the reference flattens its pytree).  A table that mixes
    ParamDefs and sub-tables (the MoE block's ``shared`` MLP beside its
    router) is a ParameterDict holding the sub-tables as modules."""
    if all(isinstance(v, dict) for v in defs.values()):
        return nn.ModuleDict({k: _build(defs[k], gen, dtype, device)
                              for k in sorted(defs)})
    return nn.ParameterDict({
        k: (_build(defs[k], gen, dtype, device) if isinstance(defs[k], dict)
            else nn.Parameter(defs[k].initialize(gen, dtype, device),
                              requires_grad=False))
        for k in sorted(defs)})


def _rebuild(module, tree: dict) -> nn.Module:
    """``module``'s structure (ModuleDicts of ParameterDicts) over the
    tensors of ``tree``, a param tree of the same keys."""
    if isinstance(module, nn.ModuleDict):
        return nn.ModuleDict({k: _rebuild(module[k], tree[k]) for k in module})
    return nn.ParameterDict({
        k: (_rebuild(v, tree[k]) if isinstance(v, nn.Module)
            else nn.Parameter(tree[k], requires_grad=False))
        for k, v in module.items()})


def param_tree(module) -> dict:
    """The parameters of a built table as a plain nested dict (the same
    tensors), keyed as the reference's pytree."""
    return {k: v if isinstance(v, torch.Tensor) else param_tree(v)
            for k, v in module.items()}


class Model(nn.Module):
    """``Model(cfg, device=None, seed=0)``: ``device`` defaults to ``cuda``
    and raises without a GPU; pass ``device="cpu"`` to run on the CPU.
    ``device="meta"`` shapes every weight as the drawn build does and
    draws nothing (the dry-run's cost counts)."""

    def __init__(self, cfg: ModelConfig, device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = _build(defs_for(cfg), self._generator(seed),
                             torch_dtype(cfg.param_dtype), self.device)
        self._periods = None
        #: (tp, index) of the split form's shards; None: whole weights
        self.tp_shard = None

    def _generator(self, seed: int) -> torch.Generator | None:
        if self.device.type == "meta":      # nothing to draw (dry runs)
            return None
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return gen

    # -- parameters -------------------------------------------------------------
    @property
    def defs(self) -> dict:
        return defs_for(self.cfg)

    def init(self, seed: int = 0) -> dict:
        """Draw every weight anew from ``seed`` (the values
        ``Model(cfg, seed=seed)`` holds), in place; returns
        :meth:`param_tree`."""
        fresh = _build(self.defs, self._generator(seed),
                       torch_dtype(self.cfg.param_dtype), self.device)
        with torch.no_grad():
            for p, q in zip(self.params.parameters(), fresh.parameters()):
                p.copy_(q)
        return self.param_tree()

    def param_tree(self) -> dict:
        return param_tree(self.params)

    def axes(self) -> dict:
        """Every parameter's logical axes (the sharding rules' input)."""
        return L.build_axes(self.defs)

    def shapes(self, dtype=None) -> dict:
        """Every parameter as a ``meta`` tensor of its shape and dtype."""
        return L.build_shapes(self.defs,
                              torch_dtype(dtype or self.cfg.param_dtype))

    def param_count(self) -> int:
        return sum(p.numel() for p in self.params.parameters())

    def with_config(self, cfg: ModelConfig) -> "Model":
        """A model over this one's weight tensors under ``cfg``, which may
        differ from ``self.cfg`` only in fields that shape no weight (the
        KV layout, its pool and page size, the kernel switches): engines of
        one model size share one set of weights."""
        if (defs_for(cfg) != self.defs
                or cfg.param_dtype != self.cfg.param_dtype):
            raise ValueError(
                f"{cfg.name}: weights differ from {self.cfg.name}'s")
        return self._over(cfg, self.params, self._periods, self.tp_shard)

    def _over(self, cfg, params, periods, tp_shard) -> "Model":
        """A model on this one's device over ``params``, not drawn."""
        other = Model.__new__(Model)
        nn.Module.__init__(other)
        other.cfg, other.device = cfg, self.device
        other.params, other._periods = params, periods
        other.tp_shard = tp_shard
        return other

    def shard(self) -> "Model":
        """The tensor-parallel split form: a model over this rank's shards
        of these weights, split over the installed mesh context's tp axis
        as ``tp_only`` splits them
        (:func:`repro_torch.parallel.sharding.tp_shard_params`: whole
        attention heads, MLP columns, experts or their columns, Mamba2
        heads with their channels and state, the vocab block; what tp does
        not divide stays whole), for decoders and enc-dec alike.  It serves
        through the same entry points and gives every rank the same
        logits.  Raises without a context, and on a model that is already
        the split form."""
        ctx = mesh_ctx.get_context()
        if ctx is None:
            raise RuntimeError("Model.shard splits over the installed mesh "
                               "context's tp axis: set one first")
        if self.tp_shard is not None:
            raise ValueError(f"already the split form {self.tp_shard}")
        cfg = self.cfg
        with torch.no_grad():
            tree = tp_shard_params(cfg, self.param_tree(), self.axes(),
                                   ctx.tp, ctx.tp_index)
        return self._over(cfg, _rebuild(self.params, tree), None,
                          (ctx.tp, ctx.tp_index))

    def whole_tree(self) -> dict:
        """The whole weights as a param tree: this model's own tensors, or,
        for the split form, every tp rank's shards gathered over the
        context's tp group and laid into their positions of the whole
        leaves (a collective: every rank calls it)."""
        if self.tp_shard is None:
            return self.param_tree()
        tp = self.tp_shard[0]
        cuts = [flatten(split_cuts(self.cfg, self.axes(), self.shapes(), tp,
                                   r)) for r in range(tp)]
        shapes = flatten(self.shapes())
        out = {}
        with torch.no_grad():
            for key, t in flatten(self.param_tree()).items():
                if cuts[0][key].dim is None:
                    out[key] = t.detach()
                    continue
                parts = mesh_ctx.tp_gather(t.detach())
                whole = t.new_empty(shapes[key].shape)
                for r in range(tp):
                    cuts[r][key].put(whole, parts[r])
                out[key] = whole
        return unflatten(self.param_tree(), out)

    def periods(self):
        """Views of the stacked weights, made once: per period for a
        decoder (:func:`repro_torch.models.transformer.period_views`), per
        encoder and decoder layer for enc-dec
        (:func:`repro_torch.models.encdec.layer_views`)."""
        if self._periods is None:
            with torch.no_grad():
                self._periods = (E.layer_views if T.is_encdec(self.cfg)
                                 else T.period_views)(self.cfg, self.params)
        return self._periods

    # -- training ---------------------------------------------------------------
    def loss(self, batch: dict, params=None) -> torch.Tensor:
        """Masked next-token cross entropy of ``batch`` (the reference's
        ``Model.loss``) over ``params`` (this model's by default), with
        the stacked weights indexed afresh so that gradients reach them."""
        params = self.params if params is None else params
        if T.is_encdec(self.cfg):
            return E.lm_loss(self.cfg, params, batch)
        return T.lm_loss(self.cfg, params, batch)

    # -- serving ----------------------------------------------------------------
    def init_cache(self, batch_size: int, max_len: int,
                   src_len: int | None = None, dtype=None) -> dict:
        if T.is_encdec(self.cfg):
            return E.init_cache(self.cfg, batch_size, max_len,
                                src_len or max_len, self.device, dtype,
                                E.local_kv_heads(self.cfg, self.params))
        return T.init_cache(self.cfg, batch_size, max_len, self.device, dtype,
                            T.local_widths(self.cfg, self.params))

    @torch.no_grad()
    def forward(self, batch: dict) -> torch.Tensor:
        """Hidden states [B, S, d] of ``batch["tokens"]`` [B, S] or
        ``batch["embeds"]`` [B, S, d]; see
        :func:`repro_torch.models.transformer.forward`."""
        return T.forward(self.cfg, self.params, batch, periods=self.periods())

    @torch.no_grad()
    def encode(self, embeds: torch.Tensor) -> torch.Tensor:
        """Enc-dec: encoder states of frame embeddings [B, S_src, d]."""
        return E.encode(self.cfg, self.params, embeds, self.periods())

    @torch.no_grad()
    def prepare_cross_cache(self, embeds: torch.Tensor, cache: dict) -> dict:
        """Enc-dec: the cache with its cross-attention K/V filled from
        ``embeds``; see :func:`repro_torch.models.encdec.prepare_cross_cache`."""
        return E.prepare_cross_cache(self.cfg, self.params, embeds, cache,
                                     self.periods())

    @torch.no_grad()
    def prefill(self, batch: dict, max_len: int):
        """(last-position logits, batch-layout cache) of the prompt; see
        :func:`repro_torch.models.transformer.prefill`.  Enc-dec has none:
        its serving starts from :meth:`prepare_cross_cache`."""
        if T.is_encdec(self.cfg):
            raise NotImplementedError("encdec prefill = prepare_cross_cache")
        return T.prefill(self.cfg, self.params, batch, max_len,
                         periods=self.periods())

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache: dict,
                    lengths: torch.Tensor, write_mask=None):
        """One decode step; see :func:`repro_torch.models.transformer.decode_step`
        or, for enc-dec, :func:`repro_torch.models.encdec.decode_step`
        (which, as the reference's, has no masked-write path and does not
        read ``write_mask``)."""
        if T.is_encdec(self.cfg):
            return E.decode_step(self.cfg, self.params, tokens, cache,
                                 lengths, self.periods())
        return T.decode_step(self.cfg, self.params, tokens, cache, lengths,
                             write_mask, periods=self.periods())
