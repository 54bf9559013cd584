"""Decode-step parity of the port against the JAX reference on one smoke
config, shared by the port's model tests (``test_torch_model.py``,
``test_torch_moe.py``).

Both frameworks take the same weights (drawn by numpy from a seed with the
reference's distributions, the QKV biases too, which it zeroes: a test
with zero biases would prove nothing of the bias path),
the same random cache contents (pages and, for Mamba2 blocks, conv and SSD
state), scrambled block tables whose page 0 is one shared read-only frame,
and the same tokens; three decode steps with one slot masked off.  Logits
must agree within atol 1e-4 and every cache entry within 1e-4 of the
larger of 1 and its largest magnitude (f32: the same arithmetic in another
summation order; the K/V rows of the second layer reach ~30 at these
inits, and their f32 sums then differ by up to ~1e-4)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import Model as JaxModel
from repro.models import transformer as jax_T
from repro.models.layers import ParamDef
from repro_torch.models.config import ModelConfig
from repro_torch.weights import from_jax_params

B, MAX_LEN, SLOTS = 3, 24, 4
ATOL = 1e-4


def pooled(cfg):
    """``cfg`` on the pooled layout with SLOTS-slot pages."""
    return dataclasses.replace(cfg, kv_layout="pooled", kv_page_slots=SLOTS)


def port_cfg(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


def seeded_params(cfg, rng) -> dict:
    """Weights of the reference's parameter tree drawn by numpy from
    ``rng`` with its initialiser's distributions (normal with the std of
    its fan-in rule, ones, the SSM inits), except that the leaves it zeroes
    (the QKV biases) are drawn normal too."""
    def draw(d):
        if d.init == "ones":
            a = np.ones(d.shape)
        elif d.init == "ssm_a":
            a = np.log(rng.uniform(1.0, 16.0, d.shape))
        elif d.init == "ssm_dt":
            a = rng.uniform(np.log(1e-3), np.log(1e-1), d.shape)
        else:
            fan_in = d.shape[0] if len(d.shape) > 1 else d.shape[-1]
            std = 1.0 if d.init == "zeros" else (d.scale or fan_in ** -0.5)
            a = rng.normal(size=d.shape) * std
        return a.astype(np.float32)
    return jax.tree.map(draw, JaxModel(cfg).defs,
                        is_leaf=lambda v: isinstance(v, ParamDef))


def tables(rng, max_lpages):
    """Scrambled block tables over B * max_lpages frames; page 0 of every
    sequence is one shared read-only frame."""
    n_frames = B * max_lpages
    bt = np.full((B, max_lpages), -1, np.int32)
    fl = np.zeros((n_frames,), np.int32)
    fr = np.zeros((n_frames,), bool)
    free = list(rng.permutation(n_frames))
    sh = int(free.pop())
    fr[sh] = True
    for s in range(B):
        bt[s, 0] = sh
        for lp in range(1, max_lpages):
            f = int(free.pop())
            bt[s, lp], fl[f] = f, lp
    return {"block_table": bt, "frame_lpage": fl, "frame_ro": fr}


def assert_decode_matches_jax(cfg, params_np, seed=5, steps=3):
    """Run ``steps`` decode steps of pooled ``cfg`` through both frameworks
    and hold logits and caches to the tolerances above."""
    rng = np.random.default_rng(seed)
    state = {key: {name: rng.normal(size=a.shape).astype(np.float32)
                   for name, a in entry.items()}
             for key, entry in JaxModel(cfg).init_cache(B, MAX_LEN).items()
             if key != "vm"}
    vm = tables(rng, -(-MAX_LEN // SLOTS))
    jcache = {key: {n: jnp.asarray(a) for n, a in entry.items()}
              for key, entry in {**state, "vm": vm}.items()}
    params = jax.tree.map(jnp.asarray, params_np)
    model = from_jax_params(port_cfg(cfg), params_np, device="cpu")
    pcache = model.init_cache(B, MAX_LEN)
    for key, entry in state.items():
        for name, a in entry.items():
            pcache[key][name].copy_(torch.tensor(a))
    pcache["vm"] = {k: torch.tensor(v) for k, v in vm.items()}
    lengths = np.array([3, 9, 14], np.int32)     # slot 0 writes the RO frame
    wm = np.array([True, True, False])
    jax_step = jax.jit(functools.partial(jax_T.decode_step, cfg))
    for _ in range(steps):
        toks = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        jl, jcache = jax_step(params, jnp.asarray(toks), jcache,
                              jnp.asarray(lengths), jnp.asarray(wm))
        pl, pcache = model.decode_step(torch.tensor(toks), pcache,
                                       torch.tensor(lengths), torch.tensor(wm))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
        lengths = lengths + 1
    for key, entry in state.items():
        for name in entry:
            want = np.asarray(jcache[key][name])
            np.testing.assert_allclose(
                pcache[key][name].numpy(), want, rtol=0,
                atol=ATOL * max(1.0, float(np.abs(want).max())),
                err_msg=f"{key}/{name}")
