"""The port's Mixture-of-Experts family against the JAX reference.

``moe_block`` (scatter and sort dispatch) against the reference's on the
same weights and inputs, f32, atol 1e-5: the routing (top-k ids, ties
lowest index first), each (token, choice)'s position in its expert's
buffer and so the pairs dropped past the capacity, and the output, with
shared experts and a capacity factor of 0.1 (tests/test_models.py:89);
the port's dense oracle against its dispatch with no drops.  Decode-step
logits of the qwen2-moe, mixtral and jamba smoke configs on the pooled
layout (tests/torch_decode_parity.py: atol 1e-4).  The initialiser's
distributions for the MoE leaves.  Serving: the qwen2-moe smoke config
serves the reference engine's tokens, telemetry and counters, fused and
stepwise; at decode its capacity (2 of 4 slots x 4 choices over 8
experts) drops pairs, so the idle slots' rows count as in the reference.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_smoke_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import ModelConfig as JaxConfig  # noqa: E402
from repro.models import moe as jax_M  # noqa: E402
from repro.models.layers import ParamDef, build_params  # noqa: E402
from repro.serve import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serve import Scheduler as JaxScheduler  # noqa: E402
from repro.serve import SchedulerConfig as JaxSchedulerConfig  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve import TraceConfig as JaxTraceConfig  # noqa: E402
from repro.serve import generate as jax_generate  # noqa: E402
from repro.serve import replay as jax_replay  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serve import (EngineConfig, Scheduler,  # noqa: E402
                               SchedulerConfig, ServeEngine, TraceConfig,
                               generate, replay)
from repro_torch.weights import from_jax_params  # noqa: E402
from torch_decode_parity import (assert_decode_matches_jax,  # noqa: E402
                                 port_cfg, pooled, seeded_params)

torch.set_num_threads(2)

ATOL = 1e-5
# tests/test_models.py _moe_cfg, and two cases of it
BLOCK_CASES = {
    "drops-shared": dict(n_experts=4, n_experts_active=2, n_shared_experts=2,
                         d_expert=16, moe_capacity_factor=0.1),
    "roomy": dict(n_experts=8, n_experts_active=2, moe_capacity_factor=8.0),
}


def _moe_cfg(dispatch, **kw):
    return JaxConfig(**{**dict(
        name="m", family="moe", n_layers=2, d_model=32, n_heads=4,
        n_kv_heads=2, head_dim=8, d_ff=64, vocab_size=64,
        param_dtype="float32", compute_dtype="float32",
        moe_dispatch=dispatch), **kw})


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.tensor(v)
            for k, v in tree.items()}


def _block_inputs(cfg, seed):
    """Reference params and an input [2, 16, 32] whose rows 3 and 20 are
    zero: their router logits are all 0, so every expert ties."""
    p = jax.tree.map(np.asarray, build_params(jax_M.moe_defs(cfg),
                                              jax.random.key(seed),
                                              jnp.float32))
    x = np.random.default_rng(seed).normal(size=(2, 16, 32)).astype(
        np.float32)
    x.reshape(32, 32)[[3, 20]] = 0.0
    return p, x


def _first_come(flat_e):
    """Position of each (token, choice) in its expert's buffer, by the
    reference's rule: the count of earlier pairs with the same expert."""
    seen: dict[int, int] = {}
    pos = np.empty_like(flat_e)
    for i, e in enumerate(flat_e):
        pos[i] = seen.get(int(e), 0)
        seen[int(e)] = pos[i] + 1
    return pos


@pytest.mark.parametrize("case", list(BLOCK_CASES))
@pytest.mark.parametrize("dispatch", ["scatter", "sort"])
def test_moe_block_matches_jax(dispatch, case):
    """Routing, positions, drops and output against the reference's block
    of the same dispatch, and the two dispatches of the port against each
    other."""
    cfg = _moe_cfg(dispatch, **BLOCK_CASES[case])
    p_np, x = _block_inputs(cfg, seed=len(case))
    want = np.asarray(jax_M.moe_block(cfg, jax.tree.map(jnp.asarray, p_np),
                                      jnp.asarray(x)))
    pcfg, p = port_cfg(cfg), _torch_tree(p_np)
    got = M.moe_block(pcfg, p, torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    other = dataclasses.replace(
        pcfg, moe_dispatch="sort" if dispatch == "scatter" else "scatter")
    np.testing.assert_allclose(M.moe_block(other, p, torch.tensor(x)).numpy(),
                               want, atol=ATOL, rtol=0)
    # the reference's routing and the pairs it keeps
    xt = jnp.asarray(x.reshape(-1, 32))
    probs = jax.nn.softmax((xt @ p_np["router"]).astype(jnp.float32), -1)
    _, jidx = jax.lax.top_k(probs, cfg.n_experts_active)
    jidx = np.asarray(jidx)
    _, _, idx = M._route(pcfg, p, torch.tensor(x.reshape(-1, 32)))
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_array_equal(jidx[[3, 20]], [[0, 1], [0, 1]])
    flat_e = idx.reshape(-1)
    pos = _first_come(jidx.reshape(-1))
    np.testing.assert_array_equal(
        M._scatter_positions(flat_e, cfg.n_experts).numpy(), pos)
    np.testing.assert_array_equal(
        M._sorted_positions(flat_e, cfg.n_experts)[0].numpy(), pos)
    cap = M.moe_capacity(pcfg, 32)
    dropped = int((pos >= cap).sum())
    assert dropped > 0 if case == "drops-shared" else dropped == 0, dropped


def test_dense_oracle_matches_dispatch():
    """With no drops the dense oracle (every expert on every token) equals
    both dispatches, with and without shared experts, and the reference's
    oracle (atol 1e-5 and rtol 1e-6: its einsums sum in another order,
    over outputs up to ~40)."""
    for kw in ({}, dict(n_shared_experts=2, d_expert=16)):
        cfg = _moe_cfg("scatter", n_experts=4, n_experts_active=2,
                       moe_capacity_factor=8.0, **kw)
        p_np, x = _block_inputs(cfg, seed=3)
        pcfg, p = port_cfg(cfg), _torch_tree(p_np)
        oracle = M.moe_block_dense_oracle(pcfg, p, torch.tensor(x)).numpy()
        want = np.asarray(jax_M.moe_block_dense_oracle(
            cfg, jax.tree.map(jnp.asarray, p_np), jnp.asarray(x)))
        np.testing.assert_allclose(oracle, want, atol=ATOL, rtol=1e-6)
        for dispatch in ("scatter", "sort"):
            got = M.moe_block(dataclasses.replace(pcfg, moe_dispatch=dispatch),
                              p, torch.tensor(x)).numpy()
            np.testing.assert_allclose(got, oracle, atol=ATOL, rtol=1e-6)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mixtral-8x7b",
                                  "jamba-v0.1-52b"])
def test_moe_arch_decode_step_logits_match_jax(arch):
    """qwen2-moe (shared experts, QKV bias drawn nonzero), mixtral (window
    8) and jamba (one attention and seven Mamba2 layers, MoE on the odd
    ones, SSD state 8) at decode, where the capacity drops pairs."""
    cfg = pooled(get_smoke_config(arch))
    # 3 rows a step: an expert chosen by all three drops a pair
    assert M.moe_capacity(port_cfg(cfg), 3) == 2
    assert_decode_matches_jax(cfg, seeded_params(cfg, np.random.default_rng(4)))


def test_moe_init_matches_reference_distributions():
    """The MoE leaves' shapes are the reference's, drawn with its
    distributions: normal with std of the stacked dim's size (the number
    of periods, the reference's fan-in quirk)."""
    cfg = dataclasses.replace(get_smoke_config("qwen2-moe-a2.7b"), n_layers=4)
    ref = jax.tree.map(lambda d: d.shape, JaxModel(cfg).defs,
                       is_leaf=lambda v: isinstance(v, ParamDef))
    p = Model(port_cfg(cfg), device="cpu", seed=2).params
    moe = p["b0"]["moe"]
    assert {k: tuple(v.shape) for k, v in moe.items()
            if k != "shared"} == {k: v for k, v in ref["b0"]["moe"].items()
                                  if k != "shared"}
    assert {k: tuple(v.shape) for k, v in moe["shared"].items()} \
        == ref["b0"]["moe"]["shared"]
    for leaf in ("router", "w_gate", "w_up", "w_down", "shared_gate"):
        assert abs(moe[leaf].std().item() - 4 ** -0.5) < 0.03, leaf
    assert abs(moe["shared"]["w_up"].std().item() - 4 ** -0.5) < 0.03
    assert len(list(p.parameters())) == len(
        jax.tree.leaves(ref, is_leaf=lambda v: isinstance(v, tuple)))


# -- serving -------------------------------------------------------------------

# the slo workload's trace (benchmarks/vm_bench.py _SLO_TRACE)
TRACE = dict(seed=11, n_requests=18, arrival_rate=0.35, n_prompts=6,
             zipf_alpha=1.2, prompt_len_short=4, prompt_len_long=12,
             prompt_long_frac=0.25, tail_len=2, out_len_short=2,
             out_len_long=6, out_long_frac=0.25, vocab_size=64)
SLOTS, MAX_LEN, POOL = 4, 32, 10
MODES = {"stepwise": 1, "fused": 8}
ENGINE = dict(slots=SLOTS, max_len=MAX_LEN, preempt_mode="swap",
              retain_frames=4)


@pytest.fixture(scope="module")
def moe_serving():
    """The qwen2-moe smoke config on a 10-frame pool (it swaps), seeded
    weights (QKV biases nonzero), and the reference engine's outputs and
    stats per mode."""
    cfg = dataclasses.replace(pooled(get_smoke_config("qwen2-moe-a2.7b")),
                              kv_pool_pages=POOL)
    params_np = seeded_params(cfg, np.random.default_rng(0))
    params = jax.tree.map(jnp.asarray, params_np)
    out = {}
    for mode, fused in MODES.items():
        with JaxServeEngine(JaxModel(cfg), params, JaxEngineConfig(
                max_fused_steps=fused, **ENGINE)) as eng:
            done = jax_replay(jax_generate(JaxTraceConfig(**TRACE)),
                              JaxScheduler(eng, JaxSchedulerConfig(window=4)))
        stats = dict(eng.shutdown())
        stats["pool_stats"] = eng.pool_stats()
        out[mode] = ({r.uid: tuple(r.output) for r in done}, stats)
    return cfg, params_np, out


@pytest.mark.parametrize("mode", list(MODES))
def test_moe_engine_matches_jax_engine(moe_serving, mode):
    """Same tokens, telemetry, counters and pool stats as the reference's
    engine; no frame leaks; a swap happens."""
    cfg, params, ref = moe_serving
    model = from_jax_params(port_cfg(cfg), params, device="cpu")
    with ServeEngine(model, EngineConfig(max_fused_steps=MODES[mode],
                                         **ENGINE)) as eng:
        done = replay(generate(TraceConfig(**TRACE)),
                      Scheduler(eng, SchedulerConfig(window=4)))
    stats = dict(eng.shutdown())
    stats["pool_stats"] = eng.pool_stats()
    out = {r.uid: tuple(r.output) for r in done}
    ref_out, ref_stats = ref[mode]
    assert len(out) == TRACE["n_requests"]
    assert out == ref_out
    assert stats == ref_stats
    assert stats["leaked_frames"] == 0 and stats["swapped"] > 0
