"""Rank bodies of ``tests/test_torch_tp_serve.py``: the tensor-parallel
split form (``Model.shard``) served over 4 gloo ranks.

As ``tests/torch_mesh_ranks.py`` (whose spawner, timeout and decode loop
this module uses), it imports the port, torch and numpy only: each rank
saves what it saw, and the test holds that against the one-device port and
the reference in the parent process.
"""
from __future__ import annotations

import torch

import torch_mesh_ranks as R

#: the ("data", "model") meshes the 4 ranks serve on: (1, 4) puts tp 4 over
#: Hkv 2, so each rank's 2 query heads lie inside a KV-head group of 4;
#: (2, 2) gives each rank one whole group and splits the pages over 2 kv
#: ranks
MESHES = ((1, 4), (2, 2))
#: the small MoE decoders: E 4 splits its experts over tp, E 3 its columns
MOE = {"experts": dict(n_experts=4), "columns": dict(n_experts=3)}
MOE_BASE = dict(family="moe", n_experts_active=2, n_shared_experts=1,
                d_expert=16, moe_capacity_factor=1.0)
#: the engine run of the serving check: swap preemption in a 12-page pool
SERVE_POOL = 12


def dense_cfg(layout: str, pool: int = 16, **kw):
    from repro_torch.models.config import ModelConfig
    return ModelConfig(**{**R.DECODER, **kw}, kv_layout=layout,
                       kv_pool_pages=pool if layout == "pooled" else None)


def moe_cfg(case: str):
    return dense_cfg("batch", **MOE_BASE, **MOE[case])


def shapes(model) -> dict:
    """{path: shape} of the weights a model holds."""
    from repro_torch.tree import flatten
    return {k: tuple(v.shape) for k, v in flatten(model.param_tree()).items()}


def prefill_logits(model, toks):
    """Prefill of every position of ``toks`` [B, S] but the last into a
    16-position batch cache, then the last one decoded: (prefill logits,
    decode logits)."""
    n = toks.shape[1]
    first, cache = model.prefill({"tokens": torch.tensor(toks[:, :-1])},
                                 max_len=16)
    last, _ = model.decode_step(torch.tensor(toks[:, -1:]), cache,
                                torch.full((toks.shape[0],), n,
                                           dtype=torch.int32))
    return first.numpy(), last.numpy()


def counted(fn):
    """``fn()``'s result and the collectives it called."""
    from repro_torch.parallel import mesh_ctx
    mesh_ctx.reset_calls()
    out = fn()
    return out, dict(mesh_ctx.CALLS)


def split_form(rank, workdir, params, moe_params, toks, prompts):
    """On each mesh of MESHES, the split forms of the dense decoder and of
    both MoE decoders: weight shapes, decode logits on the batch, paged
    and pooled layouts with the collectives each called, prefill logits,
    and the dense decoder's tokens on a swap trace, stepwise and fused."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import Model
    from repro_torch.parallel import mesh_ctx
    from repro_torch.weights import from_jax_params
    out = {}
    for shape in MESHES:
        mesh_ctx.set_context(make_mesh(shape, ("data", "model"), "cpu"),
                             batch_axes=("data",), tp_axis="model",
                             kv_axes=("data",))
        res = out[shape] = {}
        whole = from_jax_params(dense_cfg("batch"), params, device="cpu")
        model = whole.shard()
        res["shapes"] = shapes(model)
        res["shard"] = model.tp_shard
        try:
            model.shard()
        except ValueError:
            res["reshard_refused"] = True
        res["decode"], res["calls"] = {}, {}
        for layout in ("batch", "paged", "pooled"):
            m = model.with_config(dense_cfg(layout))
            res["decode"][layout], res["calls"][layout] = counted(
                lambda: R.decode_logits(m, toks))
        res["prefill"], res["prefill_calls"] = counted(
            lambda: prefill_logits(model, toks))
        res["moe"] = {}
        for case, p in moe_params.items():
            moe = from_jax_params(moe_cfg(case), p, device="cpu").shard()
            res["moe"][case] = {"shapes": shapes(moe),
                                "decode": R.decode_logits(moe, toks),
                                "prefill": prefill_logits(moe, toks)}
        pooled = model.with_config(dense_cfg("pooled"))
        res["serve"] = {fused: R.serve(pooled, R.ServeCase(
            prompts, SERVE_POOL, fused=fused))[:2] for fused in (1, 4)}
        del whole
        mesh_ctx.clear_context()
    try:
        Model(dense_cfg("batch"), device="cpu").shard()
    except RuntimeError:
        out["no_context_refused"] = True
    R.save(workdir, "tp", rank, out)


def spawn(workdir, *args):
    return R.start(split_form, 4, workdir, workdir, *args)
