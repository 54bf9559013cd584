"""Training loop on one device: loss -> grad -> AdamW, microbatching,
metrics (a port of ``repro.train.trainer``).

A train step takes the model's loss (:meth:`repro_torch.models.model.Model.
loss`) and its gradients with ``torch.autograd.grad`` through the plain
paths (the kernels have no backward and refuse a grad-requiring input),
averages the losses and gradients of ``microbatches`` equal slices of the
batch in f32 as the reference accumulates them, and applies
:func:`repro_torch.optim.adamw.update`; the new parameters are written into
the model's tensors in place, so views of them stay valid.  The reference's
mesh and sharding fields (``dp_axes``, ``tp_axis``, ``rules``) and its
``mesh`` argument wait for the port's sharding (ROADMAP Queue 1, sharding
and meshes): the port trains on one device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.tree import flatten, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1          # gradient-accumulation steps


def _split_micro(batch: dict, n: int) -> list[dict]:
    """[B, ...] -> n batches of [B/n, ...], in order."""
    b = next(iter(batch.values())).shape[0]
    if b % n:
        raise ValueError(f"batch of {b} does not split into {n} microbatches")
    m = b // n
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            for i in range(n)]


def make_train_step(model: Model, ocfg: adamw.AdamWConfig,
                    tcfg: TrainConfig) -> Callable:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``:
    ``params`` is the model's parameter tree (updated in place and
    returned), metrics hold tensors (``loss``, ``grad_norm``, ``lr``)."""

    def value_and_grad(params, batch):
        flat = flatten(params)
        for t in flat.values():
            t.requires_grad_(True)
        with torch.enable_grad():
            loss = model.loss(batch, params)
            # a weight the loss does not read (the token table of a
            # frontend arch fed embeddings) gets zeros, as under JAX
            grads = torch.autograd.grad(loss, list(flat.values()),
                                        allow_unused=True,
                                        materialize_grads=True)
        return loss.detach(), unflatten(params, dict(zip(flat, grads)))

    def step_fn(params, opt_state, batch):
        if tcfg.microbatches > 1:
            loss, grads = None, None
            for mb in _split_micro(batch, tcfg.microbatches):
                l_mb, g_mb = value_and_grad(params, mb)
                if loss is None:
                    loss = l_mb.float()
                    grads = tree_map(lambda g: g.float(), g_mb)
                else:
                    loss = loss + l_mb
                    grads = tree_map(torch.add, grads, g_mb)
            inv = 1.0 / tcfg.microbatches
            loss = loss * inv
            grads = tree_map(lambda g: g * inv, grads)
        else:
            loss, grads = value_and_grad(params, batch)
        new, opt_state, metrics = adamw.update(ocfg, grads, opt_state,
                                               params)
        del grads
        with torch.no_grad():
            tree_map(lambda p, n: p.copy_(n), params, new)
        return params, opt_state, dict(metrics, loss=loss)

    return step_fn


@dataclasses.dataclass
class Trainer:
    """Orchestrates init, stepping and metrics on the model's device."""
    model: Model
    ocfg: adamw.AdamWConfig = adamw.AdamWConfig()
    tcfg: TrainConfig = TrainConfig()

    def __post_init__(self):
        self.step_fn = make_train_step(self.model, self.ocfg, self.tcfg)
        self._step = 0

    def init_state(self, seed: int = 0):
        """(params, opt): the model's weights drawn anew from ``seed`` (its
        own tensors, now requiring grad) and a fresh optimizer state."""
        params = self.model.init(seed)
        self.model.params.requires_grad_(True)
        return params, adamw.init(self.ocfg, params)

    def place_batch(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v).to(self.model.device)
                for k, v in batch.items()}

    def restore(self, ckpt, step: int | None = None):
        """Load ``{"params", "opt"}`` of ``ckpt``'s step (the newest by
        default) into the model's tensors, in place, and the optimizer
        state; the next step is numbered after it.  Returns (params, opt,
        step)."""
        params = self.model.param_tree()
        self.model.params.requires_grad_(True)
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
