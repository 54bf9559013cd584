"""Rank bodies of ``tests/test_torch_tp_mixers.py``: the tensor-parallel
split form (``Model.shard``) of the Mamba2 mixers and the encoder-decoder
served over 4 gloo ranks.

As ``tests/torch_mesh_ranks.py`` (whose spawner, timeout and decode loop
this module uses), it imports the port, torch and numpy only: each rank
saves what it saw, and the test holds that against the one-device port and
the reference in the parent process.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

import torch_mesh_ranks as R

#: the ("data", "model") meshes the 4 ranks serve on: tp 4, then 2 kv x 2 tp
MESHES = ((1, 4), (2, 2))
#: the decoders: every SSM head's channels split; jamba's attention at tp 4
#: > Hkv 2 puts a rank's one query head inside a KV-head group of 2
DECODERS = ("mamba2-780m", "jamba-v0.1-52b")
#: each decoder's first Mamba2 block position
MAMBA_BLOCK = {"mamba2-780m": "b0", "jamba-v0.1-52b": "b1"}
#: the layout each decoder's decode loop takes on each mesh (its prefill is
#: on the batch layout, the engine run on the pooled): jamba's pooled
#: decode at tp 4 > Hkv, its batch decode and the engine's pooled one with
#: the pages over 2 kv ranks at (2, 2); mamba2 keeps no pages
LAYOUTS = {"mamba2-780m": {(1, 4): "batch", (2, 2): "batch"},
           "jamba-v0.1-52b": {(1, 4): "pooled", (2, 2): "batch"}}
#: the mesh of jamba's engine run
SERVE_MESH = (2, 2)
ENCDEC = "seamless-m4t-medium"
#: seamless's source frames
SRC_LEN = 6
#: decode steps of each arch (every collective is a gloo round trip of a few
#: ms here, and jamba calls 24-28 a step)
STEPS = {"mamba2-780m": 8, "jamba-v0.1-52b": 4, ENCDEC: 8}
#: jamba's engine run: 2 prompts of 4-7 tokens in a 4-frame pool of 4-slot
#: pages on 2 slots swap sequences out
SERVE_PROMPTS, SERVE_POOL, SERVE_SLOTS, SERVE_MAX_LEN, SERVE_NEW = \
    2, 4, 2, 32, 4


def toks_for(arch: str):
    """``arch``'s tokens [B, STEPS[arch]], made from a seed by numpy."""
    return np.random.default_rng(0).integers(0, 512, (R.B, STEPS[arch]))


def src_embeds():
    """Seamless's frame embeddings [B, SRC_LEN, d_model], from a seed."""
    d = cfg_for(ENCDEC).d_model
    return np.random.default_rng(1).normal(
        size=(R.B, SRC_LEN, d)).astype(np.float32)


def prompts():
    """The engine run's prompts, made from a seed by numpy."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, 512, int(rng.integers(4, 8))).astype(np.int32)
            for _ in range(SERVE_PROMPTS)]


def cfg_for(arch: str, layout: str = "batch", pool: int = 16):
    """``arch``'s smoke config on ``layout`` (pages of 4 slots, as the
    decode loop's tables lay them)."""
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(
        get_smoke_config(arch), kv_layout=layout, kv_page_slots=4,
        kv_pool_pages=pool if layout == "pooled" else None)


def shapes(model) -> dict:
    """{path: shape} of the weights a model holds."""
    from repro_torch.tree import flatten
    return {k: tuple(v.shape) for k, v in flatten(model.param_tree()).items()}


def counted(fn):
    """``fn()``'s result and the collectives it called."""
    from repro_torch.parallel import mesh_ctx
    mesh_ctx.reset_calls()
    out = fn()
    return out, dict(mesh_ctx.CALLS)


def prefill_run(model, toks):
    """Prefill of every position of ``toks`` [B, S] but the last into a
    16-position batch cache, then the last one decoded: (prefill logits,
    decode logits, {block: {name: the prefill's cache}})."""
    n = toks.shape[1]
    first, cache = model.prefill({"tokens": torch.tensor(toks[:, :-1])},
                                 max_len=16)
    states = {k: {name: t.clone().numpy() for name, t in v.items()}
              for k, v in cache.items()}
    last, _ = model.decode_step(torch.tensor(toks[:, -1:]), cache,
                                torch.full((toks.shape[0],), n,
                                           dtype=torch.int32))
    return first.numpy(), last.numpy(), states


def encdec_run(model, embeds, toks):
    """``prepare_cross_cache`` of ``embeds`` [B, SRC_LEN, d], then a decode
    step for each position of ``toks`` [B, S]: (logits [S, B, V], the
    cache's shapes)."""
    b, s = toks.shape
    cache = model.prepare_cross_cache(torch.tensor(embeds),
                                      model.init_cache(b, 16, SRC_LEN))
    out = []
    for t in range(s):
        logits, cache = model.decode_step(
            torch.tensor(toks[:, t:t + 1]), cache,
            torch.full((b,), t + 1, dtype=torch.int32))
        out.append(logits.numpy())
    return np.stack(out), {k: tuple(v.shape) for k, v in cache.items()}


def serve(model, prompts):
    """``prompts`` (SERVE_NEW new tokens each) through the engine on the
    pooled layout: (per-uid tokens, shutdown stats)."""
    from repro_torch.serve import EngineConfig, Request, Scheduler, ServeEngine
    with ServeEngine(model, EngineConfig(slots=SERVE_SLOTS,
                                         max_len=SERVE_MAX_LEN)) as eng:
        sched = Scheduler(eng)
        sched.submit([Request(uid=i, prompt=p, max_new_tokens=SERVE_NEW)
                      for i, p in enumerate(prompts)])
        done = sched.run()
    return {r.uid: tuple(r.output) for r in done}, eng.shutdown()


def split_mixers(rank, workdir, params):
    """On each mesh of MESHES, the split forms of the two decoders and of
    seamless: weight shapes and the first Mamba2 block's weights; decode
    logits on LAYOUTS' layout with the collectives each called; the
    prefill's logits and states with the decode step after it; seamless's
    cross cache and decode; jamba's tokens on a swap trace on SERVE_MESH;
    the split form of every registered arch's smoke config on meta
    tensors."""
    from repro_torch.configs import list_archs
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
        for arch in DECODERS:
            model = from_jax_params(cfg_for(arch), params[arch],
                                    device="cpu").shard()
            a = res[arch] = {"shapes": shapes(model),
                             "shard": model.tp_shard,
                             "mamba": {k: v.numpy() for k, v in model
                                       .param_tree()[MAMBA_BLOCK[arch]]
                                       ["mamba"].items()}}
            m = model.with_config(cfg_for(arch, LAYOUTS[arch][shape]))
            toks = toks_for(arch)
            a["decode"], a["calls"] = counted(
                lambda: R.decode_logits(m, toks))
            a["prefill"], a["prefill_calls"] = counted(
                lambda: prefill_run(model, toks))
            if arch == "jamba-v0.1-52b" and shape == SERVE_MESH:
                a["serve"] = serve(model.with_config(
                    cfg_for(arch, "pooled", SERVE_POOL)), prompts())
        model = from_jax_params(cfg_for(ENCDEC), params[ENCDEC],
                                device="cpu").shard()
        res[ENCDEC] = {"shapes": shapes(model)}
        (res[ENCDEC]["decode"], res[ENCDEC]["cache"]), \
            res[ENCDEC]["calls"] = counted(
                lambda: encdec_run(model, src_embeds(), toks_for(ENCDEC)))
        res["every_arch"] = {arch: Model(cfg_for(arch), device="meta")
                             .shard().tp_shard for arch in list_archs()}
        mesh_ctx.clear_context()
    R.save(workdir, "mixers", rank, out)


def spawn(workdir, *args):
    return R.start(split_mixers, 4, workdir, workdir, *args)
