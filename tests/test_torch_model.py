"""The port's model against the JAX reference: the weight bridge, the
initialiser's distributions, and ``decode_step`` logits against
``repro.models.transformer.decode_step`` on the same weights, tokens,
pages and block tables (tiny_dense_cfg and the qwen3-0.6b smoke config,
pooled and paged layouts, scrambled tables with a shared read-only frame
and a masked-off write), and the other dense archs' smoke configs
through tests/torch_decode_parity.py.  Tolerance: atol 1e-4 on f32 logits
(the same arithmetic in another summation order)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from conftest import tiny_dense_cfg  # noqa: E402
from repro.configs import get_smoke_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import transformer as jax_T  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402
from torch_decode_parity import (B, MAX_LEN, SLOTS,  # noqa: E402
                                 assert_decode_matches_jax, pooled, port_cfg,
                                 seeded_params, tables)

torch.set_num_threads(2)


def _cfgs(layout):
    tiny = tiny_dense_cfg(kv_layout=layout, kv_page_slots=SLOTS)
    qwen = dataclasses.replace(get_smoke_config("qwen3-0.6b"),
                               kv_layout=layout, kv_page_slots=SLOTS)
    return {"tiny": tiny, "qwen3-smoke": qwen}


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def jax_models():
    out = {}
    for layout in ("pooled", "paged"):
        for name, cfg in _cfgs(layout).items():
            model = JaxModel(cfg)
            out[(name, layout)] = (cfg, model.init(jax.random.key(0)))
    return out


def test_weight_bridge_roundtrip(jax_models):
    """Every reference parameter lands in the port's parameter of the same
    path, unchanged; a shape mismatch raises."""
    cfg, params = jax_models[("qwen3-smoke", "pooled")]
    pcfg = port_cfg(cfg)
    tree = _np_tree(params)
    model = from_jax_params(pcfg, tree, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat) == len(list(model.parameters()))
    for path, leaf in flat:
        t = model.params
        for k in path:
            t = t[k.key]
        np.testing.assert_array_equal(t.numpy(), leaf)
    bad = jax.tree.map(lambda a: a, tree)
    bad["ln_f"]["w"] = np.ones(3, np.float32)
    with pytest.raises(ValueError):
        from_jax_params(pcfg, bad, device="cpu")


def test_init_matches_reference_distributions():
    """Seeded init: stacked weights have std n_periods**-0.5 (the stacked
    dim is the reference's fan-in), the embedding std 1, norms are ones;
    the same seed gives the same weights."""
    cfg = tiny_dense_cfg(n_layers=4, d_model=128, d_ff=256, vocab_size=512,
                         kv_layout="pooled")
    a = Model(port_cfg(cfg), device="cpu", seed=3)
    b = Model(port_cfg(cfg), device="cpu", seed=3)
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    wq = a.params["b0"]["attn"]["wq"]
    assert wq.shape == (4, 128, 64)
    assert abs(wq.std().item() - 4 ** -0.5) < 0.02
    assert abs(a.params["embed"]["tok"].std().item() - 1.0) < 0.02
    assert torch.equal(a.params["ln_f"]["w"], torch.ones(128))
    assert not any(p.requires_grad for p in a.parameters())


@pytest.mark.parametrize("layout", ["pooled", "paged"])
@pytest.mark.parametrize("name", ["tiny", "qwen3-smoke"])
def test_decode_step_logits_match_jax(jax_models, name, layout):
    """Three decode steps through both frameworks on the same weights,
    pages, tables and tokens: logits within atol 1e-4, pages within the
    same tolerance (the written K/V rows come out of the matmuls)."""
    cfg, params = jax_models[(name, layout)]
    rng = np.random.default_rng(5)
    max_lpages = -(-MAX_LEN // SLOTS)
    jcache = JaxModel(cfg).init_cache(B, MAX_LEN)
    shape = jcache["b0"]["k_pages"].shape
    kp = rng.normal(size=shape).astype(np.float32)
    vp = rng.normal(size=shape).astype(np.float32)
    vm = tables(rng, max_lpages)
    jcache = {"b0": {"k_pages": jnp.asarray(kp), "v_pages": jnp.asarray(vp)},
              "vm": {k: jnp.asarray(v) for k, v in vm.items()}}
    model = from_jax_params(port_cfg(cfg), _np_tree(params), device="cpu")
    pcache = model.init_cache(B, MAX_LEN)
    pcache["b0"]["k_pages"].copy_(torch.tensor(kp))
    pcache["b0"]["v_pages"].copy_(torch.tensor(vp))
    pcache["vm"] = {k: torch.tensor(v) for k, v in vm.items()}
    lengths = np.array([3, 9, 14], np.int32)     # slot 0 writes the RO frame
    wm = np.array([True, True, False])
    for _ in range(3):
        toks = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        jl, jcache = jax_T.decode_step(cfg, params, jnp.asarray(toks), jcache,
                                       jnp.asarray(lengths), jnp.asarray(wm))
        pl, pcache = model.decode_step(torch.tensor(toks), pcache,
                                       torch.tensor(lengths), torch.tensor(wm))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
        lengths = lengths + 1
    for name_ in ("k_pages", "v_pages"):
        np.testing.assert_allclose(pcache["b0"][name_].numpy(),
                                   np.asarray(jcache["b0"][name_]),
                                   atol=1e-4, rtol=0)
    # the read-only shared frame and the masked slot's pages are untouched
    sh = int(vm["block_table"][0, 0])
    np.testing.assert_array_equal(pcache["b0"]["k_pages"][:, sh].numpy(),
                                  kp[:, sh])


@pytest.mark.parametrize("arch", ["granite-3-2b", "h2o-danube-1.8b",
                                  "qwen2-72b"])
def test_dense_arch_decode_step_logits_match_jax(arch):
    """The other dense archs' smoke configs on the pooled layout
    (tests/torch_decode_parity.py): granite's tied embeddings and padded
    vocab, danube's window of 8, which bites within MAX_LEN 24, and
    qwen2-72b's QKV bias, drawn nonzero from the seed in both frameworks."""
    cfg = pooled(get_smoke_config(arch))
    params = seeded_params(cfg, np.random.default_rng(9))
    if cfg.qkv_bias:
        assert np.abs(params["b0"]["attn"]["bq"]).min() > 0
    if cfg.window:
        assert cfg.window < MAX_LEN - 3
    assert_decode_matches_jax(cfg, params)


def test_registry_serves_the_reference_decoder_archs():
    """The port's registry lists the reference registry's archs but its
    enc-dec and VLM ones, with the same configs; ``check_supported``
    refuses exactly those two."""
    from repro.configs import get_config, list_archs
    from repro_torch import configs as port_configs
    from repro_torch.models.transformer import check_supported
    waiting = {"seamless-m4t-medium", "qwen2-vl-7b"}
    assert set(port_configs.list_archs()) == set(list_archs()) - waiting
    for arch in list_archs():
        cfg = port_cfg(get_config(arch))
        if arch in waiting:
            with pytest.raises(NotImplementedError):
                check_supported(cfg)
            continue
        check_supported(cfg)
        assert port_configs.get_config(arch) == cfg
        assert port_configs.get_smoke_config(arch) == port_cfg(
            get_smoke_config(arch))
