"""AdamW with mixed-precision master weights (a port of
``repro.optim.adamw``, functional over nested dicts of tensors).

When model params are sub-f32 (bf16), the optimizer keeps f32 master copies
and f32 moments; updates apply in f32 and the params are re-cast from the
masters.  Global-norm clipping comes first, then bias correction at the
step taken as f32, then the decoupled weight decay inside the update, in
the reference's order.  The state is a dict with the reference's names
(``step``, ``mu``, ``nu``, ``master``), so checkpoints of either package
restore in the other.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float | Callable[[torch.Tensor], torch.Tensor] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float | None = 1.0
    keep_master: bool = True      # f32 master copies for sub-f32 params


def init(cfg: AdamWConfig, params: dict) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    any_leaf = leaves(params)[0]
    state = {
        "step": torch.zeros((), dtype=torch.int32, device=any_leaf.device),
        "mu": tree_map(zeros, params),
        "nu": tree_map(zeros, params),
    }
    if cfg.keep_master and any(p.dtype != torch.float32
                               for p in leaves(params)):
        state["master"] = tree_map(lambda p: p.detach().float().clone(),
                                   params)
    return state


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the f32 sum of squares of every leaf, summed leaf by leaf in
    flattening order."""
    total = None
    for g in leaves(tree):
        sq = torch.sum(torch.square(g.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def update(cfg: AdamWConfig, grads: dict, state: dict, params: dict):
    """Returns (new_params, new_state, metrics): new tensors, nothing
    written in place."""
    step = state["step"] + 1
    lr = cfg.lr(step) if callable(cfg.lr) else cfg.lr
    gnorm = global_norm(grads)
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
        # in f32, as JAX promotes a bf16 gradient times an f32 scale
        grads = tree_map(lambda g: g.float() * scale, grads)
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(cfg.b1, stepf)
    b2c = 1.0 - torch.pow(cfg.b2, stepf)
    masters = state.get("master", params)

    def upd(g, mu, nu, w):
        g = g.float()
        w = w.float()
        mu = cfg.b1 * mu + (1 - cfg.b1) * g
        nu = cfg.b2 * nu + (1 - cfg.b2) * g * g
        mhat = mu / b1c
        nhat = nu / b2c
        w = w - lr * (mhat / (torch.sqrt(nhat) + cfg.eps)
                      + cfg.weight_decay * w)
        return mu, nu, w

    out = tree_map(upd, grads, state["mu"], state["nu"], masters)
    mu, nu, new_masters = (tree_map(lambda t, i=i: t[i], out)
                           for i in range(3))
    new_params = tree_map(lambda w, p: w.to(p.dtype), new_masters, params)
    new_state = {"step": step, "mu": mu, "nu": nu}
    if "master" in state:
        new_state["master"] = new_masters
    lr = torch.as_tensor(lr, dtype=torch.float32)
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}
