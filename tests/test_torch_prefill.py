"""The port's full-sequence path and batch KV layout against the JAX
reference, on tiny configs (tests/conftest.py's tiny_dense_cfg and the
bench-tiny config of benchmarks/vm_bench.py).

``forward`` hidden states and ``prefill`` logits and K/V cache match
``repro.models.transformer`` on the same weights and tokens within atol
1e-4 (f32: the same arithmetic in another summation order), with
``attn_impl`` "chunked" and "pallas" (on CPU tensors "pallas" is the plain
oracle, as the reference's off-TPU Pallas dispatch is); prefill then one
batch-layout decode step reproduces the longer prefill; a write-masked
decode leaves the masked slots' K/V untouched and never writes a length-0
row; and the batch-layout engine serves the reference's tokens, telemetry
and counters, stepwise and fused.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from conftest import tiny_dense_cfg  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import transformer as jax_T  # noqa: E402
from repro.serve import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serve import Scheduler as JaxScheduler  # noqa: E402
from repro.serve import SchedulerConfig as JaxSchedulerConfig  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve import TraceConfig as JaxTraceConfig  # noqa: E402
from repro.serve import generate as jax_generate  # noqa: E402
from repro.serve import replay as jax_replay  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.serve import (EngineConfig, Request, Scheduler,  # noqa: E402
                               SchedulerConfig, ServeEngine, TraceConfig,
                               generate, replay)
from repro_torch.weights import from_jax_params  # noqa: E402

torch.set_num_threads(2)

ATOL = 1e-4
B, S, MAX_LEN = 2, 12, 16
IMPLS = {"chunked": dict(attn_impl="chunked"),
         "pallas-window": dict(attn_impl="pallas", window=6)}


@pytest.fixture(scope="module")
def tiny_params():
    """The reference's tiny_dense_cfg weights (attn_impl and window do not
    change their shapes, so every case shares them)."""
    return JaxModel(tiny_dense_cfg()).init(jax.random.key(0))


def _port(cfg, params):
    """The port's Model on the CPU holding the reference's weights."""
    return from_jax_params(ModelConfig(**dataclasses.asdict(cfg)),
                           jax.tree.map(np.asarray, params), device="cpu")


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=0,
                               atol=ATOL, err_msg=what)


@pytest.mark.parametrize("impl", list(IMPLS))
def test_forward_and_prefill_match_jax(tiny_params, impl):
    cfg = tiny_dense_cfg(**IMPLS[impl])
    params, model = tiny_params, _port(cfg, tiny_params)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    batch_j = {"tokens": jnp.asarray(toks)}
    batch_t = {"tokens": torch.tensor(toks)}
    _close(model.forward(batch_t), jax_T.forward(cfg, params, batch_j),
           "hidden states")
    want_logits, want_cache = jax_T.prefill(cfg, params, batch_j, MAX_LEN)
    logits, cache = model.prefill(batch_t, MAX_LEN)
    _close(logits, want_logits, "prefill logits")
    assert set(cache) == set(want_cache)
    for key, entry in want_cache.items():
        for name in ("k", "v"):
            assert tuple(cache[key][name].shape) == entry[name].shape
            _close(cache[key][name], entry[name], f"{key}/{name}")


def test_prefill_then_batch_decode_matches_longer_prefill(tiny_params):
    """prefill(S-1) + one batch-layout decode step reproduces prefill(S)'s
    logits (tests/test_arch_smoke.py:79), and the decode logits match the
    reference's decode on its own prefill cache."""
    cfg = tiny_dense_cfg(attn_impl="pallas")
    params, model = tiny_params, _port(cfg, tiny_params)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    full, _ = model.prefill({"tokens": torch.tensor(toks)}, MAX_LEN)
    _, cache = model.prefill({"tokens": torch.tensor(toks[:, :-1])}, MAX_LEN)
    lengths = torch.full((B,), S, dtype=torch.int32)
    dec, _ = model.decode_step(torch.tensor(toks[:, -1:]), cache, lengths)
    _close(dec, full, "prefill + decode vs prefill")
    _, jcache = jax_T.prefill(cfg, params, {"tokens": jnp.asarray(toks[:, :-1])},
                              MAX_LEN)
    jdec, _ = jax_T.decode_step(cfg, params, jnp.asarray(toks[:, -1:]), jcache,
                                jnp.full((B,), S, jnp.int32))
    _close(dec, jdec, "decode logits vs reference")


def test_write_masked_decode_keeps_other_slots(tiny_params):
    """A decode step with slot 1 masked off leaves slot 1's batch K/V
    byte-identical and matches the reference's masked cache; a length-0
    slot writes nothing (its index -1 must not wrap to the last position).
    At engine level, admitting a request mid-flight does not change an
    in-flight one's tokens (tests/test_models.py:258, batch layout)."""
    cfg = tiny_dense_cfg(attn_impl="pallas")
    params, model = tiny_params, _port(cfg, tiny_params)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (3, 8))
    _, cache = model.prefill({"tokens": torch.tensor(toks)}, MAX_LEN)
    _, jcache = jax_T.prefill(cfg, params, {"tokens": jnp.asarray(toks)},
                              MAX_LEN)
    before = {k: {n: t.clone() for n, t in e.items()} for k, e in cache.items()}
    new = np.array([[5], [6], [7]])
    lengths, mask = np.array([9, 9, 0], np.int32), np.array([True, False, True])
    model.decode_step(torch.tensor(new), cache, torch.tensor(lengths),
                      write_mask=torch.tensor(mask))
    _, jcache = jax_T.decode_step(cfg, params, jnp.asarray(new), jcache,
                                  jnp.asarray(lengths), jnp.asarray(mask))
    for key, entry in cache.items():
        for name, t in entry.items():
            assert torch.equal(t[:, 1], before[key][name][:, 1])
            assert torch.equal(t[:, 2], before[key][name][:, 2])
            assert not torch.equal(t[:, 0], before[key][name][:, 0])
            _close(t, jcache[key][name], f"{key}/{name}")

    assert model.cfg.kv_layout == "batch"
    rng = np.random.default_rng(0)
    pa, pb = (rng.integers(0, 64, n).astype(np.int32) for n in (5, 6))

    def run(admit_b):
        eng = ServeEngine(model, EngineConfig(slots=2, max_len=32))
        ra = Request(uid=0, prompt=pa, max_new_tokens=6)
        eng.admit(ra, 0)
        eng.step()
        eng.step()
        if admit_b:
            eng.admit(Request(uid=1, prompt=pb, max_new_tokens=2), 1)
        while eng.slot_req[0] is not None:
            eng.step()
        eng.shutdown(abort=True)
        return ra.output

    assert run(admit_b=False) == run(admit_b=True)


# -- batch-layout serving --------------------------------------------------------

# the slo workload's trace (benchmarks/vm_bench.py _SLO_TRACE)
TRACE = dict(seed=11, n_requests=18, arrival_rate=0.35, n_prompts=6,
             zipf_alpha=1.2, prompt_len_short=4, prompt_len_long=12,
             prompt_long_frac=0.25, tail_len=2, out_len_short=2,
             out_len_long=6, out_long_frac=0.25, vocab_size=64)
SLOTS, ENGINE_MAX_LEN = 4, 32
MODES = {"stepwise": 1, "fused": 8}


def _bench_tiny():
    # benchmarks/vm_bench.py _tiny_model, on the batch layout; "pallas"
    # sends the port's decode through flash_ops (its plain branch here)
    return dict(name="bench-tiny", family="dense", n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=64,
                param_dtype="float32", compute_dtype="float32",
                attn_chunk_q=16, attn_chunk_k=16, kv_layout="batch",
                attn_impl="pallas")


@pytest.fixture(scope="module")
def batch_runs():
    """The reference engine on the batch layout, once per mode:
    (port model, outputs, stats)."""
    from repro.models import ModelConfig as JaxConfig
    jcfg = JaxConfig(**_bench_tiny())
    jmodel = JaxModel(jcfg)
    params = jmodel.init(jax.random.key(0))
    model = _port(jcfg, params)
    out = {}
    for mode, fused in MODES.items():
        with JaxServeEngine(jmodel, params, JaxEngineConfig(
                slots=SLOTS, max_len=ENGINE_MAX_LEN,
                max_fused_steps=fused)) as eng:
            done = jax_replay(jax_generate(JaxTraceConfig(**TRACE)),
                              JaxScheduler(eng, JaxSchedulerConfig(window=4)))
        out[mode] = ({r.uid: tuple(r.output) for r in done}, eng.shutdown())
    return model, out


@pytest.mark.parametrize("mode", list(MODES))
def test_batch_engine_matches_jax_engine(batch_runs, mode):
    """Same tokens, telemetry and counters as the reference's batch-layout
    engine on the slo trace; no BlockManager, clean shutdown."""
    model, runs = batch_runs
    ref_out, ref_stats = runs[mode]
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
    assert stats["telemetry"] == ref_stats["telemetry"]
    assert stats == ref_stats
