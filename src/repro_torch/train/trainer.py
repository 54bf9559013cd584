"""Training loop: loss -> grad -> AdamW, microbatching, metrics, on one
device or on a mesh of ranks (a port of ``repro.train.trainer``).

A train step takes the model's loss (:meth:`repro_torch.models.model.Model.
loss`) and its gradients with ``torch.autograd.grad`` through the plain
paths (the kernels have no backward and refuse a grad-requiring input),
averages the losses and gradients of ``microbatches`` equal slices of the
batch in f32 as the reference accumulates them, and applies
:func:`repro_torch.optim.adamw.update`.

``Trainer(model, None, ...)`` trains on the model's device: the new
parameters are written into the model's tensors in place, so views of them
stay valid.

``Trainer(model, mesh, ...)`` trains on a ``DeviceMesh`` over a started
process group, as explicit FSDP in DTensor's idiom:

  * state -- params, ``mu``, ``nu`` and ``master`` are DTensors placed by
    the rule set's specs (:func:`make_state_specs`); every rank draws the
    full weights from the seed, as one device does, and keeps its shard,
    so every mesh starts from the same bits;
  * forward -- the model's own tensors hold the gathered weights: after
    each update every leaf is gathered (``full_tensor``) into them, and
    the loss runs on them with grad on over the rank's rows of the batch,
    the contiguous block of its flat index over ``dp_axes`` (as
    ``P("data")`` places them);
  * gradients -- each comes back as ``DTensor.from_local(g, mesh,
    [Partial("avg") on each dp dim, Replicate() on the others])``,
    redistributed to its parameter's placements (a reduce-scatter).  The
    tp ranks of one dp coordinate compute the same rows, so their
    gradients are replicated, not partial;
  * loss -- weighted by the rank's share of the unmasked tokens (times the
    dp size), so that the dp average is the global masked mean one device
    takes, and all-reduced over the flat dp group, so every rank reports
    the same loss.

At one rank every gather and reduction is the identity and a step equals
the one-device step bit for bit.  Tensor-parallel compute (heads and MLP
columns split over the tp axis, an all-reduce after ``wo`` and
``w_down``) is not here: tp ranks hold their shards of the state and
gather them as the dp shards are gathered.  The collectives a mesh step
issues are counted in :data:`CALLS`.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.device import torch_dtype
from repro_torch.launch.mesh import mesh_shape
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.parallel import mesh_ctx
from repro_torch.parallel import sharding as shd
from repro_torch.tree import flatten, tree_map, unflatten

#: collectives of mesh steps since :func:`reset_calls`: leaves gathered,
#: gradients reduce-scattered, all-reduces (token count, loss, the global
#: norm's one)
CALLS = {"gather": 0, "reduce_scatter": 0, "all_reduce": 0}


def reset_calls() -> None:
    for name in CALLS:
        CALLS[name] = 0


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1          # gradient-accumulation steps
    dp_axes: tuple[str, ...] = ("data",)
    tp_axis: str = "model"
    rules: str = "fsdp_tp"


def make_state_specs(model: Model, mesh, tcfg: TrainConfig):
    """Specs for (params, opt_state), as tuples: ``(pspecs, opt_specs,
    opt_specs with master, rules)``."""
    rules = shd.rule_set(tcfg.rules, tcfg.dp_axes, tcfg.tp_axis)
    pspecs = shd.params_pspecs(model.axes(), rules, mesh, model.shapes())
    opt_specs = {"step": (), "mu": pspecs, "nu": pspecs}
    # master copies shard exactly like params
    opt_specs_master = dict(opt_specs, master=pspecs)
    return pspecs, opt_specs, opt_specs_master, rules


def _split_micro(batch: dict, n: int) -> list[dict]:
    """[B, ...] -> n batches of [B/n, ...], in order."""
    b = next(iter(batch.values())).shape[0]
    if b % n:
        raise ValueError(f"batch of {b} does not split into {n} microbatches")
    m = b // n
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            for i in range(n)]


def _loss_and_grads(model: Model, tcfg: TrainConfig, params, batch: dict,
                    weight=None):
    """(loss, gradient tree) of ``batch`` over ``params``, averaged over
    the microbatches; with ``weight`` the loss is multiplied by it before
    the gradients are taken."""

    def value_and_grad(mb):
        flat = flatten(params)
        for t in flat.values():
            t.requires_grad_(True)
        with torch.enable_grad():
            loss = model.loss(mb, params)
            if weight is not None:
                loss = loss * weight
            # a weight the loss does not read (the token table of a
            # frontend arch fed embeddings) gets zeros, as under JAX
            grads = torch.autograd.grad(loss, list(flat.values()),
                                        allow_unused=True,
                                        materialize_grads=True)
        return loss.detach(), unflatten(params, dict(zip(flat, grads)))

    if tcfg.microbatches == 1:
        return value_and_grad(batch)
    loss, grads = None, None
    for mb in _split_micro(batch, tcfg.microbatches):
        l_mb, g_mb = value_and_grad(mb)
        if loss is None:
            loss = l_mb.float()
            grads = tree_map(lambda g: g.float(), g_mb)
        else:
            loss = loss + l_mb
            grads = tree_map(torch.add, grads, g_mb)
    inv = 1.0 / tcfg.microbatches
    return loss * inv, tree_map(lambda g: g * inv, grads)


def _token_count(batch: dict) -> torch.Tensor:
    """The batch's unmasked tokens, as an f32 scalar on its device."""
    mask = batch.get("mask")
    if mask is not None:
        return mask.float().sum()
    labels = batch["labels"]
    return torch.tensor(float(labels.numel()), device=labels.device)


def make_train_step(model: Model, ocfg: adamw.AdamWConfig, mesh,
                    tcfg: TrainConfig) -> tuple[Callable, Any, Any]:
    """``(step, params_shardings, opt_shardings)``: ``step(params,
    opt_state, batch) -> (params, opt_state, metrics)`` updates ``params``
    in place and returns them, metrics hold tensors (``loss``,
    ``grad_norm``, ``lr``).  Without a mesh the shardings are None; on one
    the batch is the rank's rows (:meth:`Trainer.place_batch`)."""
    if mesh is None:
        def step_fn(params, opt_state, batch):
            loss, grads = _loss_and_grads(model, tcfg, params, batch)
            new, opt_state, metrics = adamw.update(ocfg, grads, opt_state,
                                                   params)
            del grads
            with torch.no_grad():
                tree_map(lambda p, n: p.copy_(n), params, new)
            return params, opt_state, dict(metrics, loss=loss)
        return step_fn, None, None

    pspecs, opt_nm, opt_m, _ = make_state_specs(model, mesh, tcfg)
    has_master = ocfg.keep_master \
        and torch_dtype(model.cfg.param_dtype) != torch.float32
    params_sh = tree_map(lambda s: shd.NamedSharding.from_spec(mesh, s),
                         pspecs)
    opt_sh = tree_map(lambda s: shd.NamedSharding.from_spec(mesh, s),
                      opt_m if has_master else opt_nm)
    dp = tuple(tcfg.dp_axes)
    n_dp = math.prod(mesh_shape(mesh)[a] for a in dp)
    dp_group = mesh_ctx.axes_group(mesh, dp)
    grad_placements = tuple(Partial("avg") if name in dp else Replicate()
                            for name in mesh.mesh_dim_names)

    def reduce(g, p):
        CALLS["reduce_scatter"] += 1
        return DTensor.from_local(g, mesh, grad_placements,
                                  run_check=False).redistribute(
                                      mesh, p.placements)

    def step_fn(params, opt_state, batch):
        full = model.param_tree()
        count = _token_count(batch)
        total = count.clone()
        dist.all_reduce(total, group=dp_group)
        weight = count * n_dp / torch.clamp(total, min=1.0)
        loss, grads = _loss_and_grads(model, tcfg, full, batch, weight)
        dist.all_reduce(loss, group=dp_group)
        loss = loss / n_dp
        CALLS["all_reduce"] += 3
        grads = tree_map(reduce, grads, params)
        new, opt_state, metrics = adamw.update(ocfg, grads, opt_state,
                                               params)
        del grads
        with torch.no_grad():
            tree_map(lambda p, n: p.to_local().copy_(n.to_local()), params,
                     new)
        del new
        _gather_into(full, params)
        return params, opt_state, dict(metrics, loss=loss)

    return step_fn, params_sh, opt_sh


@torch.no_grad()
def _gather_into(full: dict, params: dict) -> None:
    """Every DTensor leaf of ``params`` gathered whole into the matching
    tensor of ``full``, leaf by leaf in flattening order (a collective:
    every rank calls it in the same order)."""
    dest = flatten(full)
    for key, p in flatten(params).items():
        CALLS["gather"] += 1
        dest[key].copy_(p.full_tensor())


@dataclasses.dataclass
class Trainer:
    """Orchestrates init, placement on the mesh, stepping and metrics."""
    model: Model
    mesh: Any = None
    ocfg: adamw.AdamWConfig = adamw.AdamWConfig()
    tcfg: TrainConfig = TrainConfig()

    def __post_init__(self):
        if self.mesh is not None \
                and self.mesh.device_type != self.model.device.type:
            raise ValueError(f"a {self.mesh.device_type} mesh cannot train a "
                             f"model on {self.model.device}")
        self.step_fn, self.params_sh, self.opt_sh = make_train_step(
            self.model, self.ocfg, self.mesh, self.tcfg)
        self._step = 0

    def init_state(self, seed: int = 0):
        """(params, opt): the model's weights drawn anew from ``seed`` (its
        own tensors, now requiring grad; on a mesh each rank's shards of
        them) and a fresh optimizer state."""
        params = self.model.init(seed)
        self.model.params.requires_grad_(True)
        if self.mesh is not None:
            with torch.no_grad():
                params = tree_map(lambda p, sh: sh.place(p.detach()), params,
                                  self.params_sh)
        return params, adamw.init(self.ocfg, params)

    def place_batch(self, batch: dict) -> dict:
        """The batch on the model's device; on a mesh, the rank's rows."""
        out = {k: torch.as_tensor(v) for k, v in batch.items()}
        if self.mesh is not None:
            dp = tuple(self.tcfg.dp_axes)
            n = math.prod(mesh_shape(self.mesh)[a] for a in dp)
            b = next(iter(out.values())).shape[0]
            if b % n:
                raise ValueError(f"a batch of {b} rows does not split over "
                                 f"{n} data-parallel ranks")
            i, m = mesh_ctx.flat_index(self.mesh, dp), b // n
            out = {k: v[i * m:(i + 1) * m] for k, v in out.items()}
        return {k: v.to(self.model.device) for k, v in out.items()}

    def restore(self, ckpt, step: int | None = None):
        """Load ``{"params", "opt"}`` of ``ckpt``'s step (the newest by
        default); the next step is numbered after it.  On one device the
        parameters go into the model's tensors, in place; on a mesh the
        state is placed by the trainer's shardings and the parameters
        gathered into the model's tensors.  Returns (params, opt, step)."""
        params = self.model.param_tree()
        self.model.params.requires_grad_(True)
        if self.mesh is not None:
            like = {"params": self.params_sh, "opt": self.opt_sh}
            tree, step = ckpt.restore(like, step, shardings=like)
            _gather_into(params, tree["params"])
            self._step = step
            return tree["params"], tree["opt"], step
        like = {"params": params, "opt": adamw.init(self.ocfg, params)}
        tree, step = ckpt.restore(like, step)
        with torch.no_grad():
            tree_map(lambda p, t: p.copy_(t), params, tree["params"])
        self._step = step
        return params, tree["opt"], step

    def _sync(self) -> None:
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)

    def run(self, params, opt, data_iter, n_steps: int,
            hooks: list[Callable] | None = None):
        history = []
        for _ in range(n_steps):
            batch = self.place_batch(next(data_iter))
            self._sync()
            t0 = time.monotonic()
            params, opt, metrics = self.step_fn(params, opt, batch)
            self._sync()
            metrics = {k: float(v) for k, v in metrics.items()}
            metrics["step_time_s"] = time.monotonic() - t0
            metrics["step"] = self._step
            history.append(metrics)
            self._step += 1
            for h in hooks or []:
                h(self._step, params, opt, metrics)
        return params, opt, history
