"""Rank bodies of ``tests/test_torch_tp_train.py``: the mesh trainer's
tensor-parallel step (each tp rank's loss and gradients on its split form)
over 4 gloo ranks.

As ``tests/torch_mesh_ranks.py`` (whose spawner and timeout this module
uses), it imports the port, torch and numpy only: each rank saves what it
saw, and the test holds that against the one-device port and the
reference in the parent process.  :func:`run` is also the one-device run
(``mesh=None``) the test holds the ranks to.
"""
from __future__ import annotations

import dataclasses

import torch

import torch_mesh_ranks as R

#: the ("data", "model") meshes the 4 ranks train on: tp 4, then 2 dp x 2 tp
MESHES = ((1, 4), (2, 2))
#: a dense decoder (tp 4 > Hkv 2: a rank's KV head shared, ``q_norm``),
#: an MoE with shared experts, the SSM, the hybrid and the enc-dec
ARCHS = ("qwen3-0.6b", "qwen2-moe-a2.7b", "mamba2-780m", "jamba-v0.1-52b",
         "seamless-m4t-medium")
#: the archs with MoE blocks (their expert choices pinned)
MOE = ("qwen2-moe-a2.7b", "jamba-v0.1-52b")
#: steps, rows and tokens of a step, the learning rate
STEPS, B, S, LR = 2, 4, 16, 1e-3
#: the weights' and the compute's dtype
DTYPE = "float64"


def cfg_for(arch: str, dtype: str = DTYPE):
    """``arch``'s smoke config (remat "block") in ``dtype``, with attention
    chunks of 8 so the chunked attention takes several blocks."""
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config(arch), attn_chunk_q=8,
                               attn_chunk_k=8, param_dtype=dtype,
                               compute_dtype=dtype)


class Routes:
    """The MoE blocks' expert choices: with ``pinned`` None each
    ``moe._route`` call's top-k ids are recorded; given ``pinned`` ids,
    each call takes the pinned ids of the same call in order, its weights
    renormalised from its own probabilities at those ids, and counts the
    tokens whose own choice differed (``flips``)."""

    def __init__(self, pinned=None):
        self.pinned, self.ids, self.flips = pinned, [], 0

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.route = moe, moe._route
        moe._route = self._route
        return self

    def __exit__(self, *exc):
        self.moe._route = self.route

    def _route(self, cfg, p, xt):
        probs, weights, idx = self.route(cfg, p, xt)
        if self.pinned is None:
            self.ids.append(idx.numpy().copy())
            return probs, weights, idx
        pinned = torch.from_numpy(self.pinned[len(self.ids)])
        self.ids.append(pinned.numpy())
        self.flips += int((idx.sort(-1).values != pinned.sort(-1).values)
                          .any(-1).sum())
        weights = probs.gather(1, pinned)
        return probs, weights / weights.sum(-1, keepdim=True), pinned


def whole(tree) -> dict:
    """{path: numpy} of a tree, DTensor leaves gathered (every rank
    together)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.tree import flatten
    return {k: (v.full_tensor() if isinstance(v, DTensor) else v)
            .detach().numpy().copy() for k, v in flatten(tree).items()}


def dp_share(routes: list, n_dp: int, dp_index: int) -> list:
    """The choices of the rows of dp index ``dp_index`` of ``n_dp`` in one
    step of a one-device run over the whole batch (one microbatch): of
    every call, the rank's block of the tokens (its rows of the batch, in
    dp order)."""
    out = []
    for ids in routes:
        n = len(ids) // n_dp
        out.append(ids[dp_index * n:(dp_index + 1) * n])
    return out


def dp_joined(shares: list) -> list:
    """The inverse of :func:`dp_share`: the dp ranks' choices (one list of
    calls each, in dp order) joined call by call over the whole batch."""
    import numpy as np
    return [np.concatenate(calls) for calls in zip(*shares)]


def _load(trainer, state: dict):
    """A one-device trainer's (params, opt) holding the whole ``state``
    ({"params/...", "opt/..."} as numpy)."""
    from repro_torch.optim import adamw
    from repro_torch.tree import flatten
    params = trainer.model.param_tree()
    opt = adamw.init(trainer.ocfg, params)
    with torch.no_grad():
        for name, tree in (("params", params), ("opt", opt)):
            for k, v in flatten(tree).items():
                v.copy_(torch.from_numpy(state[f"{name}/{k}"]))
    return params, opt


def run(arch: str, mesh=None, *, pins=(None,) * STEPS, microbatches: int = 1,
        start: dict | None = None, steps=range(STEPS)) -> dict:
    """The ``steps`` (indices into STEPS) of ``arch`` on ``mesh`` (None: one
    device of ``microbatches``), from seed 0 (``Trainer.init_state``) or,
    on one device, from the whole ``start`` state: per step the loss and
    grad norm, the gradients whole, the collectives (the model's and the
    trainer's), the MoE choices taken (``pins[step]``, or recorded where
    None) and their flips; on a mesh also the whole state after each step,
    and the shapes and shard record of the model's tensors and its weights
    gathered whole (``Model.whole_tree``) after the last.  Gradients are
    kept of the first step run, the state after step 0 and the weights
    after the last step (each leaf a collective on a mesh)."""
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models.model import Model
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.parallel import mesh_ctx
    from repro_torch.train import trainer as T
    from repro_torch.tree import flatten
    cfg = cfg_for(arch)
    trainer = T.Trainer(Model(cfg, device="cpu"), mesh, AdamWConfig(lr=LR),
                        T.TrainConfig(microbatches=microbatches))
    params, opt = trainer.init_state(seed=0)
    if start is not None:
        params, opt = _load(trainer, start)
    data = SyntheticLM(cfg, DataConfig(B, S))
    out = {k: [] for k in ("hist", "grads", "calls", "routes", "flips",
                           "state")}
    update = adamw.update

    def keep(ocfg, g, *args):
        if not out["grads"]:
            out["grads"].append(whole(g))
        return update(ocfg, g, *args)
    adamw.update = keep
    try:
        for step in steps:
            mesh_ctx.reset_calls()
            T.reset_calls()
            with Routes(pins[step]) as routes:
                params, opt, h = trainer.run(
                    params, opt, iter([data.global_batch(step)]), 1)
            out["hist"].append((h[0]["loss"], h[0]["grad_norm"]))
            out["calls"].append({"model": dict(mesh_ctx.CALLS),
                                 "trainer": dict(T.CALLS)})
            out["routes"].append(routes.ids)
            out["flips"].append(routes.flips)
            if mesh is not None and step == 0:
                out["state"].append(whole({"params": params, "opt": opt}))
    finally:
        adamw.update = update
    if mesh is not None:
        model = trainer.model
        out.update(shard=model.tp_shard,
                   shapes={k: tuple(v.shape) for k, v in
                           flatten(model.param_tree()).items()},
                   model=whole(model.whole_tree()), params=whole(params))
    return out


def tp_train(rank, workdir, pinned):
    """:func:`run` of every arch on each mesh of MESHES, the MoE archs'
    first-step choices pinned to ``pinned[shape][arch]`` (the one-device
    run's over the whole batch, of which a dp rank takes its rows')."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import mesh_ctx
    out = {}
    for shape in MESHES:
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        dp_index = mesh_ctx.flat_index(mesh, ("data",))
        out[shape] = {}
        for arch in ARCHS:
            first = pinned[shape].get(arch)
            pins = (None if first is None
                    else dp_share(first, shape[0], dp_index), None)
            out[shape][arch] = run(arch, mesh, pins=pins)
        mesh_ctx.clear_context()
    R.save(workdir, "tp_train", rank, out)


def spawn(workdir, pinned):
    return R.start(tp_train, 4, workdir, workdir, pinned)
