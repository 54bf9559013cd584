"""Model facade: an ``nn.Module`` holding the weights of a served decoder
(a port of ``repro.models.model``).

Weights are drawn from an explicit ``torch.Generator`` on the model's device
with the reference's distributions; they are stacked over layer periods
exactly as the reference's param pytree, so
:func:`repro_torch.weights.from_jax_params` can load that pytree one tensor
at a time.  The model runs inference only (forward, prefill, decode):
parameters never require gradients.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


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


class Model(nn.Module):
    """``Model(cfg, device=None, seed=0)``: ``device`` defaults to ``cuda``
    and raises without a GPU; pass ``device="cpu"`` to run on the CPU."""

    def __init__(self, cfg: ModelConfig, device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.params = _build(T.decoder_defs(cfg), gen,
                             torch_dtype(cfg.param_dtype), self.device)
        self._periods = None

    def with_config(self, cfg: ModelConfig) -> "Model":
        """A model over this one's weight tensors under ``cfg``, which may
        differ from ``self.cfg`` only in fields that shape no weight (the
        KV layout, its pool and page size, the kernel switches): engines of
        one model size share one set of weights."""
        if (T.decoder_defs(cfg) != T.decoder_defs(self.cfg)
                or cfg.param_dtype != self.cfg.param_dtype):
            raise ValueError(
                f"{cfg.name}: weights differ from {self.cfg.name}'s")
        other = Model.__new__(Model)
        nn.Module.__init__(other)
        other.cfg, other.device = cfg, self.device
        other.params, other._periods = self.params, self._periods
        return other

    def periods(self) -> list[dict]:
        """Per-period views of the stacked block weights, made once."""
        if self._periods is None:
            self._periods = [T.period_params(self.params, j)
                             for j in range(self.cfg.n_periods)]
        return self._periods

    def init_cache(self, batch_size: int, max_len: int, dtype=None) -> dict:
        return T.init_cache(self.cfg, batch_size, max_len, self.device, dtype)

    @torch.no_grad()
    def forward(self, batch: dict) -> torch.Tensor:
        """Hidden states [B, S, d] of ``batch["tokens"]`` [B, S]; see
        :func:`repro_torch.models.transformer.forward`."""
        return T.forward(self.cfg, self.params, batch, periods=self.periods())

    @torch.no_grad()
    def prefill(self, batch: dict, max_len: int):
        """(last-position logits, batch-layout cache) of the prompt; see
        :func:`repro_torch.models.transformer.prefill`."""
        return T.prefill(self.cfg, self.params, batch, max_len,
                         periods=self.periods())

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache: dict,
                    lengths: torch.Tensor, write_mask=None):
        """One decode step; see :func:`repro_torch.models.transformer.decode_step`."""
        return T.decode_step(self.cfg, self.params, tokens, cache, lengths,
                             write_mask, periods=self.periods())
