"""Weight bridge: the reference's JAX param pytree, as nested dicts of numpy
arrays stacked over layer periods, into the port's :class:`Model`.

Tests build the reference params with ``jax.random``, convert them with
``jax.tree.map(np.asarray, params)`` and hand them over here; the port
itself never sees JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes: widen exactly, narrow back
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(a)


def from_jax_params(cfg: ModelConfig, params_np: dict, *,
                    device=None) -> Model:
    """A :class:`Model` on ``device`` (``cuda`` unless given) holding exactly
    ``params_np``.  Every array must match the port's parameter of the same
    path in shape; values are cast to the config's ``param_dtype``."""
    model = Model(cfg, device=device)

    def load(mod, tree, path):
        names = set(mod.keys())
        if names != set(tree):
            raise ValueError(f"{path or 'params'}: keys {sorted(tree)} do not "
                             f"match the port's {sorted(names)}")
        for k in sorted(names):
            sub = mod[k]
            if isinstance(sub, torch.Tensor):
                src = _tensor(tree[k])
                if tuple(src.shape) != tuple(sub.shape):
                    raise ValueError(f"{path}{k}: shape {tuple(src.shape)} != "
                                     f"{tuple(sub.shape)}")
                with torch.no_grad():
                    sub.copy_(src.to(sub.dtype))
            else:
                load(sub, tree[k], f"{path}{k}/")

    load(model.params, params_np, "")
    return model
