"""The port's Mamba2 (SSM) family against the JAX reference, on the
mamba2-780m SMOKE config and the reference's ``t-hyb`` hybrid
(tests/test_models.py:436).

``forward`` hidden states and ``prefill`` logits and cache (``conv``,
``ssd``) match the reference's ``chunked`` path on the same weights, with
the port's ``attn_impl`` "chunked", "ref" (K5's plain version on every
device) and "pallas" (on CPU tensors K5's plain version too); values are
compared within 1e-4 of the larger of 1 and their largest magnitude (the
SSD state runs into the thousands at this config's init).  prefill(S-1)
plus one decode step reproduces prefill(S) within atol 5e-4
(tests/test_arch_smoke.py:79, the SSM tolerance).  Two reference faults
are not carried over and are pinned here: its pallas prefill stores no SSD
state, and its pallas scan needs S % chunk == 0 (S = 9 with chunk 8 raises
there).  Serving: the SMOKE config on the batch layout serves the
reference's tokens, telemetry and counters, stepwise and fused; ``t-hyb``
on the pooled layout swaps its recurrent state out and back in with the
reference's tokens.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import ModelConfig as JaxConfig  # noqa: E402
from repro.models import transformer as jax_T  # noqa: E402
from repro.models.layers import ParamDef as JaxParamDef  # noqa: E402
from repro.serve import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import Scheduler as JaxScheduler  # noqa: E402
from repro.serve import SchedulerConfig as JaxSchedulerConfig  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve import TraceConfig as JaxTraceConfig  # noqa: E402
from repro.serve import generate as jax_generate  # noqa: E402
from repro.serve import replay as jax_replay  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.layers import ParamDef  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serve import (EngineConfig, Request, Scheduler,  # noqa: E402
                               SchedulerConfig, ServeEngine, TraceConfig,
                               generate, replay)
from repro_torch.weights import from_jax_params  # noqa: E402

torch.set_num_threads(2)

B, S, MAX_LEN = 2, 16, 32


@pytest.fixture(scope="module")
def smoke():
    """The reference's mamba2 SMOKE config and weights."""
    cfg = jax_smoke_config("mamba2-780m")
    return cfg, JaxModel(cfg).init(jax.random.key(0))


@pytest.fixture(scope="module")
def smoke_ref(smoke):
    """The reference's chunked forward and prefill of the same tokens:
    (tokens, hidden states, (logits, cache))."""
    cfg, params = smoke
    toks = _tokens(cfg, S)
    bj = {"tokens": jnp.asarray(toks)}
    return (toks, jax_T.forward(cfg, params, bj),
            jax_T.prefill(cfg, params, bj, MAX_LEN))


def _port(cfg, params, **kw):
    """The port's Model on the CPU holding the reference's weights."""
    pcfg = ModelConfig(**dataclasses.asdict(dataclasses.replace(cfg, **kw)))
    return from_jax_params(pcfg, jax.tree.map(np.asarray, params),
                           device="cpu")


def _close(got, want, what, tol=1e-4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (what, err)


def _tokens(cfg, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, s))


@pytest.mark.parametrize("impl", ["chunked", "ref", "pallas"])
def test_forward_and_prefill_match_jax(smoke, smoke_ref, impl):
    cfg, params = smoke
    model = _port(cfg, params, attn_impl=impl)
    toks, hidden, (want_logits, want_cache) = smoke_ref
    bt = {"tokens": torch.tensor(toks)}
    _close(model.forward(bt), hidden, "hidden")
    logits, cache = model.prefill(bt, MAX_LEN)
    _close(logits, want_logits, "logits")
    assert set(cache) == set(want_cache) == {"b0"}
    assert cache["b0"]["ssd"].dtype == torch.float32
    for name in ("conv", "ssd"):
        _close(cache["b0"][name], want_cache["b0"][name], name)


def test_prefill_then_decode_matches_longer_prefill(smoke):
    """prefill(S-1) + one decode step == prefill(S) through K5's dispatch
    (attn_impl "pallas") at S = 16, 9 (not a multiple of the chunk: the
    reference's pallas scan asserts there) and 2 (a prompt shorter than the
    conv window: its tail is left-padded with the conv's zeros); the pallas
    prefill stores the same SSD state as the chunked one (the reference's
    stores None), and at S = 16 the decode logits match the reference's
    decode on its own chunked prefill cache."""
    cfg, params = smoke
    model = _port(cfg, params, attn_impl="pallas")
    chunked = _port(cfg, params)
    for s in (16, 9, 2):
        toks = _tokens(cfg, s, seed=s)
        full, _ = model.prefill({"tokens": torch.tensor(toks)}, MAX_LEN)
        _, cache = model.prefill({"tokens": torch.tensor(toks[:, :-1])},
                                 MAX_LEN)
        _, want = chunked.prefill({"tokens": torch.tensor(toks[:, :-1])},
                                  MAX_LEN)
        assert cache["b0"]["ssd"].abs().max() > 0
        _close(cache["b0"]["ssd"], want["b0"]["ssd"], f"ssd state S={s}")
        lengths = torch.full((B,), s, dtype=torch.int32)
        dec, _ = model.decode_step(torch.tensor(toks[:, -1:]), cache, lengths)
        np.testing.assert_allclose(dec[:, :cfg.vocab_size].numpy(),
                                   full[:, :cfg.vocab_size].numpy(),
                                   rtol=1e-4, atol=5e-4, err_msg=f"S={s}")
        if s == S:
            _, jc = jax_T.prefill(cfg, params,
                                  {"tokens": jnp.asarray(toks[:, :-1])},
                                  MAX_LEN)
            jdec, _ = jax_T.decode_step(cfg, params, jnp.asarray(toks[:, -1:]),
                                        jc, jnp.full((B,), s, jnp.int32))
            _close(dec, jdec, f"decode vs reference S={s}")


def test_write_masked_decode_keeps_masked_state(smoke):
    """A decode step with row 1 masked off leaves row 1's conv and SSD
    state byte-identical and matches the reference's masked cache."""
    cfg, params = smoke
    model = _port(cfg, params)
    toks = _tokens(cfg, 8, seed=3)
    _, cache = model.prefill({"tokens": torch.tensor(toks)}, MAX_LEN)
    _, jcache = jax_T.prefill(cfg, params, {"tokens": jnp.asarray(toks)},
                              MAX_LEN)
    before = {n: t.clone() for n, t in cache["b0"].items()}
    new, lengths = np.array([[5], [6]]), np.array([9, 9], np.int32)
    mask = np.array([True, False])
    logits, _ = model.decode_step(torch.tensor(new), cache,
                                  torch.tensor(lengths),
                                  write_mask=torch.tensor(mask))
    jlogits, jcache = jax_T.decode_step(cfg, params, jnp.asarray(new), jcache,
                                        jnp.asarray(lengths),
                                        jnp.asarray(mask))
    _close(logits, jlogits, "masked decode logits")
    for name, t in cache["b0"].items():
        assert torch.equal(t[:, 1], before[name][:, 1])
        assert not torch.equal(t[:, 0], before[name][:, 0])
        _close(t, jcache["b0"][name], name)


def test_init_matches_reference_distributions():
    """a_log is the log of U[1, 16] and dt_bias U[log 1e-3, log 1e-1], as
    the reference draws them (its sample's quantiles beside the port's);
    the Model's Mamba2 parameters take those initialisers."""
    n = 20000
    gen = torch.Generator().manual_seed(0)
    for init, lo, hi, to_u in (("ssm_a", 1.0, 16.0, np.exp),
                               ("ssm_dt", math.log(1e-3), math.log(1e-1),
                                lambda v: v)):
        ours = to_u(ParamDef((n,), init).initialize(
            gen, torch.float32, "cpu").numpy())
        ref = to_u(np.asarray(JaxParamDef((n,), (None,), init).initialize(
            jax.random.key(0), jnp.float32)))
        assert lo - 1e-5 <= ours.min() and ours.max() <= hi + 1e-5
        qs = np.linspace(0.05, 0.95, 10)
        np.testing.assert_allclose(np.quantile(ours, qs),
                                   np.quantile(ref, qs),
                                   atol=0.03 * (hi - lo), err_msg=init)
        np.testing.assert_allclose(np.quantile(ours, qs),
                                   lo + qs * (hi - lo),
                                   atol=0.03 * (hi - lo), err_msg=init)
    cfg = ModelConfig(**dataclasses.asdict(jax_smoke_config("mamba2-780m")))
    p = Model(cfg, device="cpu", seed=1).params["b0"]["mamba"]
    assert set(p) == {"w_in", "conv_w", "conv_b", "a_log", "dt_bias",
                      "d_skip", "norm_w", "w_out"}
    a = torch.exp(p["a_log"])
    assert a.shape == (2, cfg.ssm_heads)
    assert bool(((a >= 1 - 1e-5) & (a <= 16 + 1e-5)).all())
    assert bool(((p["dt_bias"] >= math.log(1e-3) - 1e-6)
                 & (p["dt_bias"] <= math.log(1e-1) + 1e-6)).all())


# -- serving -------------------------------------------------------------------

# the slo workload's trace (benchmarks/vm_bench.py _SLO_TRACE)
TRACE = dict(seed=11, n_requests=18, arrival_rate=0.35, n_prompts=6,
             zipf_alpha=1.2, prompt_len_short=4, prompt_len_long=12,
             prompt_long_frac=0.25, tail_len=2, out_len_short=2,
             out_len_long=6, out_long_frac=0.25, vocab_size=64)
SLOTS, ENGINE_MAX_LEN = 4, 32
MODES = {"stepwise": 1, "fused": 8}


@pytest.fixture(scope="module")
def ssm_runs(smoke):
    """The reference engine serving the SMOKE config on the batch layout,
    once per mode: (outputs, stats)."""
    cfg, params = smoke
    out = {}
    for mode, fused in MODES.items():
        with JaxServeEngine(JaxModel(cfg), params, JaxEngineConfig(
                slots=SLOTS, max_len=ENGINE_MAX_LEN,
                max_fused_steps=fused)) as eng:
            done = jax_replay(jax_generate(JaxTraceConfig(**TRACE)),
                              JaxScheduler(eng, JaxSchedulerConfig(window=4)))
        out[mode] = ({r.uid: tuple(r.output) for r in done}, eng.shutdown())
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_ssm_engine_matches_jax_engine(smoke, ssm_runs, mode):
    """Same tokens, telemetry and counters as the reference's engine on the
    slo trace: slots are reused (their recurrent state zeroed), prompts
    prefill through the write-masked decode step and fused runs carry the
    state with idle rows masked off."""
    cfg, params = smoke
    model = _port(cfg, params, attn_impl="pallas")
    ref_out, ref_stats = ssm_runs[mode]
    with ServeEngine(model, EngineConfig(
            slots=SLOTS, max_len=ENGINE_MAX_LEN,
            max_fused_steps=MODES[mode])) as eng:
        assert eng.blocks is None
        done = replay(generate(TraceConfig(**TRACE)),
                      Scheduler(eng, SchedulerConfig(window=4)))
    stats = eng.shutdown()
    out = {r.uid: tuple(r.output) for r in done}
    assert len(out) == TRACE["n_requests"]
    assert out == ref_out
    assert stats == ref_stats


def _hybrid_cfg(pool: int) -> dict:
    # tests/test_models.py:446
    return dict(name="t-hyb", family="hybrid", n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                vocab_size=64, attn_period=2, attn_offset=0, ssm_state=8,
                ssm_head_dim=16, ssm_groups=1, ssm_conv=4, ssm_expand=2,
                ssd_chunk=8, param_dtype="float32", compute_dtype="float32",
                attn_chunk_q=16, attn_chunk_k=16, kv_layout="pooled",
                kv_page_slots=4, kv_pool_pages=pool)


def test_hybrid_pooled_swap_matches_jax():
    """t-hyb on the pooled layout (tests/test_models.py:436, mirrored): with
    6 frames the engine swaps sequences out and back in, their conv/SSD
    rows riding the swap record, and serves the reference's tokens,
    telemetry and counters; with 32 frames nothing swaps and the tokens
    are the same; no frame leaks; retention is refused on a model with
    recurrent state."""
    jcfg = JaxConfig(**_hybrid_cfg(6))
    params = JaxModel(jcfg).init(jax.random.key(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 64, int(rng.integers(3, 7))).astype(np.int32)
               for _ in range(4)]

    def serve(engine, sched, req):
        with engine as eng:
            sched = sched(eng)
            sched.submit([req(uid=i, prompt=p, max_new_tokens=5)
                          for i, p in enumerate(prompts)])
            done = sched.run()
        return {r.uid: tuple(r.output) for r in done}, eng.shutdown()

    ref_out, ref_stats = serve(
        JaxServeEngine(JaxModel(jcfg), params,
                       JaxEngineConfig(slots=4, max_len=32)),
        JaxScheduler, JaxRequest)
    np_params = jax.tree.map(np.asarray, params)
    runs = {}
    for pool in (6, 32):
        model = from_jax_params(ModelConfig(**_hybrid_cfg(pool)), np_params,
                                device="cpu")
        runs[pool] = serve(ServeEngine(model, EngineConfig(slots=4,
                                                           max_len=32)),
                           Scheduler, Request)
    (tight, st_tight), (roomy, st_roomy) = runs[6], runs[32]
    assert tight == roomy == ref_out
    assert st_tight == ref_stats
    assert st_tight["swapped"] > 0 and st_tight["swap_resumed"] > 0
    assert st_roomy["swapped"] == 0
    assert st_tight["leaked_frames"] == st_roomy["leaked_frames"] == 0
    with pytest.raises(ValueError, match="attention-only"):
        ServeEngine(model, EngineConfig(slots=2, max_len=32, retain_frames=4))
