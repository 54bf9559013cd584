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
process group, as explicit FSDP and tensor parallelism in DTensor's idiom,
computing what the reference's GSPMD computes on each rank:

  * state -- params, ``mu``, ``nu`` and ``master`` are DTensors placed by
    the rule set's specs (:func:`make_state_specs`: d_model over the dp
    axes, heads, MLP columns, experts, vocab and ``ssm_inner`` over the tp
    axis); every rank draws the full weights from the seed, as one device
    does, and keeps its shard, so every mesh starts from the same bits;
  * forward -- on a tp axis of more than one rank ``trainer.model`` is the
    tensor-parallel split form (:meth:`Model.shard
    <repro_torch.models.model.Model.shard>`: the rank's heads, MLP
    columns, experts, SSM heads and vocab block), under a mesh context the
    trainer installs; at tp 1 it is the whole model.  After each update
    every leaf is gathered over the dp axes only and written into the
    model's tensor (:class:`_Leaf`): the state's tp block where it is the
    split form's cut, else that one leaf gathered over tp too (an
    all-reduce of the blocks), cut and freed -- the KV heads at tp > Hkv,
    whose split form holds the one whole head its query heads read; a
    Mamba2 mixer's ``w_in`` and conv, whose split form holds an index set
    of columns; the router, whole in the split form.  The loss runs on
    them with grad on over the rank's rows of each microbatch (the
    reference's microbatch of global rows, its block by the rank's flat
    index over ``dp_axes``, as ``P("data")`` places them:
    :func:`micro_rows`), under a mesh context that says so (``dp_rows``:
    an MoE block fills its experts' capacity over the global microbatch,
    its position offset by the earlier dp ranks' counts); the split
    blocks' collectives carry their gradients (``mesh_ctx.to_region``,
    ``tp_sum``, ``tp_sum_in_region``) and the loss is taken over the
    rank's vocab block;
  * gradients -- each leaf's goes back to its state placement: summed over
    tp where the split form holds a partial of it (a whole leaf read
    inside a split region, ``sharding.Cut.summed``; a cut the state does
    not hold as its block, scattered into the whole leaf first), then
    ``DTensor.from_local(g, mesh, [Partial("avg") on each dp dim, the
    state's tp placement])`` redistributed to the parameter's placements
    (a reduce-scatter over dp; over a dp dim of one rank the identity,
    with no collective, as the gather is);
  * loss -- each microbatch's weighted by the rank's share of its
    unmasked tokens (times the dp size, :func:`micro_weights`), so that
    the dp average is the microbatch's global masked mean, which the
    reference averages over the microbatches; all-reduced over the flat
    dp group, so every rank reports the same loss.

At one rank every gather and reduction is the identity and a step equals
the one-device step bit for bit.  The trainer's collectives are counted
in :data:`CALLS`, the model's in ``mesh_ctx.CALLS``.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.device import torch_dtype
from repro_torch.launch.mesh import mesh_shape
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.parallel import mesh_ctx
from repro_torch.parallel import sharding as shd
from repro_torch.tree import flatten, tree_map, unflatten

#: collectives of mesh steps since :func:`reset_calls`: leaves gathered
#: over dp, gradients reduce-scattered over dp (neither over a dp group of
#: one rank), all-reduces (token count,
#: loss, the global norm's one), and the all-reduces over tp of the leaves
#: and gradients the split form does not hold as the state's block
CALLS = {"gather": 0, "reduce_scatter": 0, "all_reduce": 0,
         "tp_all_reduce": 0}


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


def micro_rows(b: int, microbatches: int, n_dp: int = 1,
               dp_index: int = 0) -> list[slice]:
    """The rows of a global batch of ``b`` that dp rank ``dp_index`` of
    ``n_dp`` takes of each microbatch: microbatch ``i`` is the global rows
    ``[i*M, (i+1)*M)`` (M = b / microbatches, the reference's
    ``_split_micro``), split over the dp ranks in order, as ``P("data")``
    splits the reference's, so the rank takes ``[i*M + r*m, i*M +
    (r+1)*m)`` with m = M / n_dp."""
    if b % (microbatches * n_dp):
        raise ValueError(f"a batch of {b} rows does not split into "
                         f"{microbatches} microbatches over {n_dp} "
                         "data-parallel ranks")
    big = b // microbatches
    m = big // n_dp
    return [slice(i * big + dp_index * m, i * big + (dp_index + 1) * m)
            for i in range(microbatches)]


def _split_micro(batch: dict, n: int) -> list[dict]:
    """[B, ...] -> n batches of [B/n, ...], in order: a rank's batch (as
    :meth:`Trainer.place_batch` lays it out, its rows of each microbatch in
    turn) into its rows of each microbatch."""
    b = next(iter(batch.values())).shape[0]
    return [{k: v[rows] for k, v in batch.items()}
            for rows in micro_rows(b, n)]


def micro_weights(counts: torch.Tensor, totals: torch.Tensor,
                  n_dp: int) -> torch.Tensor:
    """The loss weight of each microbatch on a dp rank: its unmasked tokens
    ``counts`` [n] over the microbatch's ``totals`` [n] over every dp rank,
    times ``n_dp``.  The dp average of the weighted per-rank masked means
    is then each microbatch's global masked mean, and the microbatches'
    average the reference's mean of them."""
    return counts * n_dp / torch.clamp(totals, min=1.0)


def _loss_and_grads(model: Model, tcfg: TrainConfig, params, batch: dict,
                    weights=None):
    """(loss, gradient tree) of ``batch`` over ``params``, averaged over
    the microbatches; with ``weights`` [microbatches] each microbatch's
    loss is multiplied by its weight before the gradients are taken."""

    def value_and_grad(mb, weight):
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

    if weights is None:
        weights = [None] * tcfg.microbatches
    if tcfg.microbatches == 1:
        return value_and_grad(batch, weights[0])
    loss, grads = None, None
    for mb, weight in zip(_split_micro(batch, tcfg.microbatches), weights):
        l_mb, g_mb = value_and_grad(mb, weight)
        if loss is None:
            loss = l_mb.float()
            grads = tree_map(lambda g: g.float(), g_mb)
        else:
            loss = loss + l_mb
            grads = tree_map(torch.add, grads, g_mb)
    inv = 1.0 / tcfg.microbatches
    return loss * inv, tree_map(lambda g: g * inv, grads)


def _token_counts(batch: dict, microbatches: int) -> torch.Tensor:
    """The unmasked tokens of each microbatch of ``batch`` (a rank's rows
    of each, :func:`_split_micro`), as f32 [microbatches] on its device."""
    mask = batch.get("mask")
    if mask is None:
        labels = batch["labels"]
        return torch.full((microbatches,), labels.numel() / microbatches,
                          dtype=torch.float32, device=labels.device)
    return mask.float().reshape(microbatches, -1).sum(-1)


@dataclasses.dataclass(frozen=True)
class _Leaf:
    """How one parameter's split-form tensor comes from its state DTensor
    and how its gradient goes back.  ``tp_dim`` is the tensor dim the
    state splits over the tp axis (None: whole over tp) and ``block`` the
    rank's span of it; ``mode`` is "same" (the dp-gathered block is the
    split form's), "local" (the state is whole over tp: cut it), or
    "gather" (the state's block is not the cut: gather the leaf over tp,
    cut, free)."""
    cut: shd.Cut
    tp_dim: int | None
    block: tuple[int, int]
    mode: str
    shape: tuple[int, ...]


def _leaf_plan(model: Model, params_sh: dict, mesh, tcfg: TrainConfig,
               tp_index: int) -> dict:
    """{path: :class:`_Leaf`} of every parameter.  A leaf's mode is the
    same on every tp rank (its collectives are), "same" only where every
    rank's cut is its block."""
    names = tuple(mesh.mesh_dim_names)
    tp_mesh_dim = names.index(tcfg.tp_axis)
    tp = mesh_shape(mesh)[tcfg.tp_axis]
    cuts = [flatten(shd.split_cuts(model.cfg, model.axes(), model.shapes(),
                                   tp, r)) for r in range(tp)]
    plan = {}
    shapes = flatten(model.shapes())
    for key, sh in flatten(params_sh).items():
        shape = tuple(shapes[key].shape)
        place = sh.placements[tp_mesh_dim]
        tp_dim = place.dim if tp > 1 and isinstance(place, Shard) else None

        def block(r):
            if tp_dim is None:
                return (0, 0)
            n = shape[tp_dim] // tp
            return r * n, (r + 1) * n

        def held(r):
            cut = cuts[r][key]
            return (cut.dim is None and tp_dim is None) or (
                cut.dim == tp_dim and cut.span() == block(r))
        if all(held(r) for r in range(tp)):
            mode = "same"
        elif tp_dim is None:
            mode = "local"
        else:
            mode = "gather"
        plan[key] = _Leaf(cuts[tp_index][key], tp_dim, block(tp_index),
                          mode, shape)
    return plan


def make_train_step(model: Model, ocfg: adamw.AdamWConfig, mesh,
                    tcfg: TrainConfig) -> tuple[Callable, Any, Any]:
    """``(step, params_shardings, opt_shardings)``: ``step(params,
    opt_state, batch) -> (params, opt_state, metrics)`` updates ``params``
    in place and returns them, metrics hold tensors (``loss``,
    ``grad_norm``, ``lr``).  Without a mesh the shardings are None; on one
    the batch is the rank's rows (:meth:`Trainer.place_batch`), ``model``
    is the split form at tp > 1 (the whole model at tp 1), and the step
    writes the updated weights into its tensors; ``step.refresh(params)``
    writes a state's weights there."""
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
    names = tuple(mesh.mesh_dim_names)
    sizes = mesh_shape(mesh)
    n_dp = math.prod(sizes[a] for a in dp)
    # the dp dims of more than one rank: a gather or a reduction over one
    # rank is the identity, and takes no collective (gloo moves CUDA
    # tensors by all_reduce and broadcast only)
    live_dp = tuple(a for a in dp if sizes[a] > 1)
    dp_group = mesh_ctx.axes_group(mesh, dp)
    tp_group = mesh.get_group(tcfg.tp_axis)
    tp_index = mesh_ctx.flat_index(mesh, (tcfg.tp_axis,))
    plan = _leaf_plan(model, params_sh, mesh, tcfg, tp_index)

    def tp_sum(x):
        CALLS["tp_all_reduce"] += 1
        return mesh_ctx.all_reduce(x, "sum", tp_group)

    def whole_of_block(block, leaf):
        """The whole leaf from each tp rank's block: an all-reduce of the
        blocks laid into zeros (gloo's CUDA all_gather would stage through
        the host)."""
        whole = block.new_zeros(leaf.shape)
        whole.narrow(leaf.tp_dim, leaf.block[0],
                     leaf.block[1] - leaf.block[0]).copy_(block)
        return tp_sum(whole)

    @torch.no_grad()
    def refresh(params):
        """Every leaf of the state ``params`` gathered over the dp axes and
        cut to the split form, into the model's tensors (a collective:
        every rank calls it, leaf by leaf in flattening order)."""
        dest = flatten(model.param_tree())
        for key, p in flatten(params).items():
            leaf = plan[key]
            whole_over_dp = tuple(Replicate() if names[i] in live_dp else pl
                                  for i, pl in enumerate(p.placements))
            if whole_over_dp != tuple(p.placements):
                CALLS["gather"] += 1
                p = p.redistribute(mesh, whole_over_dp)
            block = p.to_local()
            if leaf.mode == "gather":
                block = whole_of_block(block, leaf)
            dest[key].copy_(block if leaf.mode == "same"
                            else leaf.cut.take(block))
            del block

    def reduce(key, g, p):
        leaf = plan[key]
        if leaf.cut.dim is not None and leaf.mode != "same":
            whole = g.new_zeros(leaf.shape)
            g = tp_sum(leaf.cut.put(whole, g))
        elif leaf.cut.summed:
            g = tp_sum(g.clone(memory_format=torch.contiguous_format))
        if leaf.tp_dim is not None and leaf.mode != "same":
            g = g.narrow(leaf.tp_dim, leaf.block[0],
                         leaf.block[1] - leaf.block[0])
        tp_place = Replicate() if leaf.tp_dim is None else Shard(leaf.tp_dim)
        placements = tuple(
            Partial("avg") if name in live_dp
            else tp_place if name == tcfg.tp_axis else Replicate()
            for name in names)
        CALLS["reduce_scatter"] += bool(live_dp)
        return DTensor.from_local(g.contiguous(), mesh, placements,
                                  run_check=False, shape=p.shape,
                                  stride=p.stride()).redistribute(
                                      mesh, p.placements)

    def step_fn(params, opt_state, batch):
        split = model.param_tree()
        counts = _token_counts(batch, tcfg.microbatches)
        totals = counts.clone()
        dist.all_reduce(totals, group=dp_group)
        loss, grads = _loss_and_grads(model, tcfg, split, batch,
                                      micro_weights(counts, totals, n_dp))
        dist.all_reduce(loss, group=dp_group)
        loss = loss / n_dp
        CALLS["all_reduce"] += 3
        flat_p = flatten(params)
        grads = unflatten(params, {k: reduce(k, g, flat_p[k])
                                   for k, g in flatten(grads).items()})
        new, opt_state, metrics = adamw.update(ocfg, grads, opt_state,
                                               params)
        del grads
        with torch.no_grad():
            tree_map(lambda p, n: p.to_local().copy_(n.to_local()), params,
                     new)
        del new
        refresh(params)
        return params, opt_state, dict(metrics, loss=loss)

    step_fn.refresh = refresh
    return step_fn, params_sh, opt_sh


@dataclasses.dataclass
class Trainer:
    """Orchestrates init, placement on the mesh, stepping and metrics.  On
    a mesh whose tp axis has more than one rank, ``model`` becomes its
    tensor-parallel split form (its tensors the rank's shards, refreshed
    from the state after every step; :meth:`Model.whole_tree
    <repro_torch.models.model.Model.whole_tree>` gathers them whole), and
    the trainer installs a mesh context over ``mesh`` (``dp_rows``: its
    model runs on a dp rank's rows) where the mesh has more than one rank
    and no such context over it is installed."""
    model: Model
    mesh: Any = None
    ocfg: adamw.AdamWConfig = adamw.AdamWConfig()
    tcfg: TrainConfig = TrainConfig()

    def __post_init__(self):
        if self.mesh is not None \
                and self.mesh.device_type != self.model.device.type:
            raise ValueError(f"a {self.mesh.device_type} mesh cannot train a "
                             f"model on {self.model.device}")
        if self.mesh is not None and self.mesh.mesh.numel() > 1:
            ctx = mesh_ctx.get_context()
            if ctx is None or ctx.mesh is not self.mesh \
                    or ctx.tp_axis != self.tcfg.tp_axis \
                    or ctx.batch_axes != tuple(self.tcfg.dp_axes) \
                    or not ctx.dp_rows:
                mesh_ctx.set_context(self.mesh,
                                     batch_axes=self.tcfg.dp_axes,
                                     tp_axis=self.tcfg.tp_axis,
                                     kv_axes=self.tcfg.dp_axes, dp_rows=True)
            if mesh_shape(self.mesh)[self.tcfg.tp_axis] > 1 \
                    and self.model.tp_shard is None:
                self.model = self.model.shard()
        self.step_fn, self.params_sh, self.opt_sh = make_train_step(
            self.model, self.ocfg, self.mesh, self.tcfg)
        self._step = 0

    def init_state(self, seed: int = 0):
        """(params, opt): the model's weights drawn anew from ``seed`` (its
        own tensors, now requiring grad; on a mesh each rank's shards of
        them, the split form's tensors cut from them) and a fresh
        optimizer state."""
        if self.mesh is None:
            params = self.model.init(seed)
            self.model.params.requires_grad_(True)
            return params, adamw.init(self.ocfg, params)
        if self.model.tp_shard is None:
            whole = self.model.init(seed)
        else:
            whole = Model(self.model.cfg, self.model.device,
                          seed).param_tree()
        with torch.no_grad():
            params = tree_map(lambda p, sh: sh.place(p.detach()), whole,
                              self.params_sh)
        del whole
        self.step_fn.refresh(params)
        self.model.params.requires_grad_(True)
        return params, adamw.init(self.ocfg, params)

    def place_batch(self, batch: dict) -> dict:
        """The batch on the model's device; on a mesh, the rank's rows of
        each microbatch in turn (:func:`micro_rows`)."""
        out = {k: torch.as_tensor(v) for k, v in batch.items()}
        if self.mesh is not None:
            dp = tuple(self.tcfg.dp_axes)
            n = math.prod(mesh_shape(self.mesh)[a] for a in dp)
            b = next(iter(out.values())).shape[0]
            rows = micro_rows(b, self.tcfg.microbatches, n,
                              mesh_ctx.flat_index(self.mesh, dp))
            out = {k: torch.cat([v[r] for r in rows]) for k, v in out.items()}
        return {k: v.to(self.model.device) for k, v in out.items()}

    def restore(self, ckpt, step: int | None = None):
        """Load ``{"params", "opt"}`` of ``ckpt``'s step (the newest by
        default); the next step is numbered after it.  On one device the
        parameters go into the model's tensors, in place; on a mesh the
        state is placed by the trainer's shardings and written into the
        model's tensors as a step writes it.  Returns (params, opt,
        step)."""
        self.model.params.requires_grad_(True)
        if self.mesh is not None:
            like = {"params": self.params_sh, "opt": self.opt_sh}
            tree, step = ckpt.restore(like, step, shardings=like)
            self.step_fn.refresh(tree["params"])
            self._step = step
            return tree["params"], tree["opt"], step
        params = self.model.param_tree()
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
