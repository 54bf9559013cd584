"""The port's enc-dec and frontend-stub paths against the JAX reference on
the CPU, through the weight bridge, with weights drawn by numpy from the
reference's ParamDefs (tests/torch_decode_parity.py) and inputs from a
numpy seed:

- seamless-m4t-medium SMOKE: ``encode``, ``prepare_cross_cache``, three
  ``decode_step``s and ``lm_loss`` under ``"chunked"`` and ``"pallas"``
  (on CPU tensors both frameworks take their plain versions there);
- qwen2-vl-7b SMOKE: ``forward`` and ``prefill`` from frame embeddings
  (``batch["embeds"]``), and decode steps through the parity helper;
- K3's plain path, non-causal with Sq > Skv, against the reference's
  ``flash_attention`` kernel in interpret mode.

Tolerances, f32 (the same arithmetic in another summation order): encoder
states, hidden states, cross K/V, caches and prefill logits within atol
1e-4 of max(1, max |value|); seamless's decode-step logits within 1e-3 of
it (with the reference's init the cross K/V reach ~32, and at the third
step both f32 paths lie 4e-4 and 8e-4 of max |logit| from a float64 run
of the port); the loss within rtol 1e-5; K3's plain path within 1e-5."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_smoke_config  # noqa: E402
from repro.models import encdec as jax_E  # noqa: E402
from repro.models import transformer as jax_T  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402
from torch_decode_parity import (assert_decode_matches_jax,  # noqa: E402
                                 pooled, port_cfg, seeded_params)

torch.set_num_threads(2)
ATOL = 1e-4
DECODE_ATOL = 1e-3
B, S_SRC, S_TGT, MAX_LEN = 2, 12, 10, 8


def close(got, want, what, atol=ATOL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(
        got, want, rtol=0, atol=atol * max(1.0, float(np.abs(want).max())),
        err_msg=what)


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_seamless_encode_decode_and_loss_match_jax(impl):
    cfg = dataclasses.replace(get_smoke_config("seamless-m4t-medium"),
                              attn_impl=impl, attn_chunk_q=4, attn_chunk_k=4)
    rng = np.random.default_rng(11)
    params_np = seeded_params(cfg, rng)
    params = jax.tree.map(jnp.asarray, params_np)
    model = from_jax_params(port_cfg(cfg), params_np, device="cpu")
    embeds = rng.normal(size=(B, S_SRC, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, S_TGT)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S_TGT)).astype(np.int32)
    mask = (rng.random((B, S_TGT)) < 0.8).astype(np.float32)

    enc = jax.jit(functools.partial(jax_E.encode, cfg))(params, embeds)
    close(model.encode(torch.tensor(embeds)), enc, "encode")

    jcache = jax.jit(functools.partial(jax_E.prepare_cross_cache, cfg))(
        params, embeds, jax_E.init_cache(cfg, B, MAX_LEN, S_SRC))
    pcache = model.prepare_cross_cache(
        torch.tensor(embeds), model.init_cache(B, MAX_LEN, src_len=S_SRC))
    for name in ("xk", "xv"):
        close(pcache[name], jcache[name], name)

    jstep = jax.jit(functools.partial(jax_E.decode_step, cfg))
    lengths = np.array([1, 3], np.int32)
    for i in range(3):
        tok = toks[:, i:i + 1]
        jl, jcache = jstep(params, tok, jcache, lengths)
        pl, pcache = model.decode_step(torch.tensor(tok), pcache,
                                       torch.tensor(lengths))
        close(pl[:, :cfg.vocab_size], np.asarray(jl)[:, :cfg.vocab_size],
              f"decode step {i}", atol=DECODE_ATOL)
        lengths = lengths + 1
    for name in ("k", "v"):
        close(pcache[name], jcache[name], name)

    batch = {"embeds": embeds, "tokens": toks, "labels": labels,
             "mask": mask}
    want = jax.jit(functools.partial(jax_E.lm_loss, cfg))(params, batch)
    with torch.no_grad():
        got = model.loss({k: torch.tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_qwen2_vl_forward_and_prefill_from_embeds_match_jax():
    cfg = get_smoke_config("qwen2-vl-7b")
    rng = np.random.default_rng(12)
    params_np = seeded_params(cfg, rng)
    assert np.abs(params_np["b0"]["attn"]["bq"]).min() > 0
    params = jax.tree.map(jnp.asarray, params_np)
    model = from_jax_params(port_cfg(cfg), params_np, device="cpu")
    embeds = rng.normal(size=(B, S_TGT, cfg.d_model)).astype(np.float32)
    batch = {"embeds": embeds}
    tbatch = {"embeds": torch.tensor(embeds)}
    close(model(tbatch), jax.jit(functools.partial(jax_T.forward, cfg))(
        params, batch), "forward")
    jl, jc = jax.jit(functools.partial(jax_T.prefill, cfg, max_len=16))(
        params, batch)
    pl, pc = model.prefill(tbatch, 16)
    close(pl[:, :cfg.vocab_size], np.asarray(jl)[:, :cfg.vocab_size],
          "prefill logits")
    for name in ("k", "v"):
        close(pc["b0"][name], jc["b0"][name], f"prefill {name}")


def test_qwen2_vl_decode_step_matches_jax():
    cfg = pooled(get_smoke_config("qwen2-vl-7b"))
    assert_decode_matches_jax(cfg, seeded_params(cfg,
                                                 np.random.default_rng(13)))


def test_k3_plain_path_takes_sq_above_skv_as_the_reference_kernel():
    """Non-causal, no window, Sq 64 > Skv 32 (cross-attention to a shorter
    source): the port's plain versions (``ops.flash_attention`` on CPU
    tensors, ``ref.mha``, ``chunked_attention``) against the reference's
    Pallas kernel in interpret mode, whose negative query offsets no mask
    reads."""
    from repro.kernels.flash_attention.kernel import flash_attention as jfa
    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.models.layers import chunked_attention
    rng = np.random.default_rng(14)
    q = rng.normal(size=(2, 4, 64, 16)).astype(np.float32)
    k = rng.normal(size=(2, 2, 32, 16)).astype(np.float32)
    v = rng.normal(size=(2, 2, 32, 16)).astype(np.float32)
    want = np.asarray(jfa(q, k, v, causal=False, block_q=32, block_k=16,
                          interpret=True))
    tq, tk, tv = map(torch.tensor, (q, k, v))
    for got in (ops.flash_attention(tq, tk, tv, causal=False),
                ref.mha(tq, tk, tv, causal=False),
                chunked_attention(tq, tk, tv, causal=False, window=None,
                                  chunk_q=16, chunk_k=8)):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_model_facade_branches_on_the_encdec_family():
    """``Model`` builds the reference's enc-dec tree (the weight bridge
    loads it with no special case), its cache takes ``src_len``, prefill
    raises as the reference's does, and enc-dec on a paged layout or
    through the serving engine is refused by name."""
    from repro.models import Model as JaxModel
    from repro_torch.models.transformer import check_supported
    cfg = get_smoke_config("seamless-m4t-medium")
    model = Model(port_cfg(cfg), device="cpu")
    shapes = jax.tree.map(lambda s: tuple(s.shape), JaxModel(cfg).shapes())
    port = jax.tree.map(lambda t: tuple(t.shape), model.param_tree())
    assert port == shapes
    assert model.param_count() == JaxModel(cfg).param_count()
    cache = model.init_cache(2, 8, src_len=5)
    assert tuple(cache["xk"].shape) == (cfg.n_layers, 2, cfg.n_kv_heads, 5,
                                        cfg.hd)
    assert tuple(cache["k"].shape) == (cfg.n_layers, 2, cfg.n_kv_heads, 8,
                                       cfg.hd)
    with pytest.raises(NotImplementedError, match="prepare_cross_cache"):
        model.prefill({"tokens": torch.zeros((1, 2), dtype=torch.int32)}, 4)
    with pytest.raises(NotImplementedError, match="batch layout"):
        check_supported(port_cfg(dataclasses.replace(cfg,
                                                     kv_layout="pooled")))
    other = model.with_config(port_cfg(dataclasses.replace(
        cfg, attn_impl="pallas")))
    assert other.params is model.params
    from repro_torch.serve import EngineConfig, ServeEngine
    with pytest.raises(NotImplementedError, match="prepare_cross_cache"):
        ServeEngine(model, EngineConfig(slots=1, max_len=8))
