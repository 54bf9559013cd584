"""AdamW with mixed-precision master weights (a port of
``repro.optim.adamw``, functional over nested dicts of tensors).

When model params are sub-f32 (bf16), the optimizer keeps f32 master copies
and f32 moments; updates apply in f32 and the params are re-cast from the
masters.  Global-norm clipping comes first, then bias correction at the
step taken as f32, then the decoupled weight decay inside the update, in
the reference's order.  The state is a dict with the reference's names
(``step``, ``mu``, ``nu``, ``master``), so checkpoints of either package
restore in the other.

On a mesh the parameters, moments and masters are DTensors sharing each
leaf's placements (the gradients come redistributed to them), and ``step``
a replicated DTensor: the update is elementwise, so it runs on each rank's
local shards with the one-device arithmetic, and only the global norm
talks across ranks (:func:`global_norm`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.tree import leaves, tree_map


def _local(t):
    """A DTensor's local shard; any other tensor as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


def _like(local: torch.Tensor, ref):
    """``local`` as the local shard of a DTensor placed as ``ref`` is (as it
    is when ``ref`` is no DTensor)."""
    if not isinstance(ref, DTensor):
        return local
    return DTensor.from_local(local, ref.device_mesh, ref.placements,
                              shape=ref.shape, stride=ref.stride(),
                              run_check=False)


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
        return _like(torch.zeros(_local(p).shape, dtype=torch.float32,
                                 device=p.device), p)
    any_leaf = leaves(params)[0]
    step = torch.zeros((), dtype=torch.int32, device=any_leaf.device)
    if isinstance(any_leaf, DTensor):
        mesh = any_leaf.device_mesh
        step = DTensor.from_local(step, mesh, (Replicate(),) * mesh.ndim,
                                  run_check=False)
    state = {
        "step": step,
        "mu": tree_map(zeros, params),
        "nu": tree_map(zeros, params),
    }
    if cfg.keep_master and any(p.dtype != torch.float32
                               for p in leaves(params)):
        state["master"] = tree_map(
            lambda p: _like(_local(p).detach().float().clone(), p), params)
    return state


def _owns_shard(t) -> bool:
    """Whether this rank's shard of ``t`` counts towards a sum over every
    rank: on each mesh dim that replicates ``t``, only index 0's does."""
    if not isinstance(t, DTensor):
        return True
    coord = t.device_mesh.get_coordinate()
    return all(c == 0 for c, pl in zip(coord, t.placements)
               if isinstance(pl, Replicate))


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the f32 sum of squares of every leaf, summed leaf by leaf in
    flattening order: the norm of the logical tensors.  For DTensor leaves
    each rank's per-leaf sums of its shards (zero where a replicating mesh
    dim has counted them already) are summed over every rank in one
    all-reduce, so every rank gets the same bits; at one rank the norm is
    the one-device norm bit for bit."""
    flat = leaves(tree)
    sqs = [torch.sum(torch.square(_local(g).float())) for g in flat]
    if isinstance(flat[0], DTensor):
        sqs = [sq if _owns_shard(g) else torch.zeros_like(sq)
               for sq, g in zip(sqs, flat)]
        vec = torch.stack(sqs)
        dist.all_reduce(vec)
        sqs = list(vec.unbind(0))
    total = None
    for sq in sqs:
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def update(cfg: AdamWConfig, grads: dict, state: dict, params: dict):
    """Returns (new_params, new_state, metrics): new tensors (DTensors
    placed as the old ones, where they were), nothing written in place."""
    step = _local(state["step"]) + 1
    lr = cfg.lr(step) if callable(cfg.lr) else cfg.lr
    gnorm = global_norm(grads)
    ref = params
    grads, params = tree_map(_local, grads), tree_map(_local, params)
    mu0, nu0 = tree_map(_local, state["mu"]), tree_map(_local, state["nu"])
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
        # in f32, as JAX promotes a bf16 gradient times an f32 scale
        grads = tree_map(lambda g: g.float() * scale, grads)
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(cfg.b1, stepf)
    b2c = 1.0 - torch.pow(cfg.b2, stepf)
    masters = tree_map(_local, state["master"]) if "master" in state \
        else params

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

    out = tree_map(upd, grads, mu0, nu0, masters)
    mu, nu, new_masters = (tree_map(lambda t, r, i=i: _like(t[i], r), out, ref)
                           for i in range(3))
    new_params = tree_map(lambda w, p, r: _like(w.to(p.dtype), r),
                          tree_map(_local, new_masters), params, ref)
    new_state = {"step": _like(step, state["step"]), "mu": mu, "nu": nu}
    if "master" in state:
        new_state["master"] = new_masters
    lr = torch.as_tensor(lr, dtype=torch.float32)
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}
