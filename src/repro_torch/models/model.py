"""Model facade: an ``nn.Module`` holding the weights of a served decoder
(a port of ``repro.models.model``).

Weights are drawn from an explicit ``torch.Generator`` on the model's device
with the reference's distributions; they are stacked over layer periods
exactly as the reference's param pytree, so
:func:`repro_torch.weights.from_jax_params` can load that pytree one tensor
at a time.  The model serves decode only: parameters never require
gradients.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


def _build(defs: dict, gen: torch.Generator, dtype, device) -> nn.Module:
    """Nested ParamDef dicts -> ModuleDicts of ParameterDicts (sorted key
    order, as the reference flattens its pytree)."""
    if all(isinstance(v, dict) for v in defs.values()):
        return nn.ModuleDict({k: _build(defs[k], gen, dtype, device)
                              for k in sorted(defs)})
    return nn.ParameterDict({
        k: nn.Parameter(defs[k].initialize(gen, dtype, device),
                        requires_grad=False)
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

    def periods(self) -> list[dict]:
        """Per-period views of the stacked block weights, made once."""
        if self._periods is None:
            self._periods = [T.period_params(self.params, j)
                             for j in range(self.cfg.n_periods)]
        return self._periods

    def init_cache(self, batch_size: int, max_len: int, dtype=None) -> dict:
        return T.init_cache(self.cfg, batch_size, max_len, self.device, dtype)

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache: dict,
                    lengths: torch.Tensor, write_mask=None):
        """One decode step; see :func:`repro_torch.models.transformer.decode_step`."""
        return T.decode_step(self.cfg, self.params, tokens, cache, lengths,
                             write_mask, periods=self.periods())
