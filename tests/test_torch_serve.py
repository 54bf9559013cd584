"""The port's serving engine and scheduler against the JAX reference.

The bench-tiny config of benchmarks/vm_bench.py (2 layers, d_model 64,
f32) serves the same seeded tracegen trace -- the `slo` workload's trace --
through both engines on the same weights (the reference's params through
the weight bridge).  Per-uid tokens, the telemetry summary and every engine
counter must be identical and shutdown must find no leaked frame; greedy
decode leaves no tolerance to state.  Inside the port, fused multi-step
decode must reproduce step-at-a-time dispatch, EOS early exit included."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.models import Model as JaxModel  # noqa: E402
from repro.models import ModelConfig as JaxConfig  # noqa: E402
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

# the slo workload's trace (benchmarks/vm_bench.py _SLO_TRACE)
TRACE = dict(seed=11, n_requests=18, arrival_rate=0.35, n_prompts=6,
             zipf_alpha=1.2, prompt_len_short=4, prompt_len_long=12,
             prompt_long_frac=0.25, tail_len=2, out_len_short=2,
             out_len_long=6, out_long_frac=0.25, vocab_size=64)
POOL, SLOTS, MAX_LEN = 10, 4, 32

CASES = {
    "pooled-swap-retain": dict(layout="pooled", preempt_mode="swap",
                               retain_frames=4),
    "paged-recompute": dict(layout="paged", preempt_mode="recompute",
                            retain_frames=0),
}


def _cfg_kw(layout):
    # benchmarks/vm_bench.py _tiny_model
    return dict(name="bench-tiny", family="dense", n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                vocab_size=64, param_dtype="float32",
                compute_dtype="float32", attn_chunk_q=16, attn_chunk_k=16,
                kv_layout=layout, kv_page_slots=4,
                kv_pool_pages=POOL if layout == "pooled" else None)


@pytest.fixture(scope="module")
def runs():
    """Each case once through the JAX engine: (port model, outputs, stats)."""
    out = {}
    for name, case in CASES.items():
        cfg_kw = _cfg_kw(case["layout"])
        jmodel = JaxModel(JaxConfig(**cfg_kw))
        params = jmodel.init(jax.random.key(0))
        with JaxServeEngine(jmodel, params, JaxEngineConfig(
                slots=SLOTS, max_len=MAX_LEN,
                preempt_mode=case["preempt_mode"],
                retain_frames=case["retain_frames"])) as eng:
            done = jax_replay(jax_generate(JaxTraceConfig(**TRACE)),
                              JaxScheduler(eng, JaxSchedulerConfig(window=4)))
        stats = dict(eng.shutdown())
        stats["pool_stats"] = eng.pool_stats()
        model = from_jax_params(ModelConfig(**cfg_kw),
                                jax.tree.map(np.asarray, params),
                                device="cpu")
        out[name] = (model, {r.uid: tuple(r.output) for r in done}, stats)
    return out


def _serve_trace(model, case, **ecfg_kw):
    # greedy=True: the reference's field, accepted and never read by either
    with ServeEngine(model, EngineConfig(
            slots=SLOTS, max_len=MAX_LEN, greedy=True,
            preempt_mode=case["preempt_mode"],
            retain_frames=case["retain_frames"], **ecfg_kw)) as eng:
        done = replay(generate(TraceConfig(**TRACE)),
                      Scheduler(eng, SchedulerConfig(window=4)))
    stats = dict(eng.shutdown())           # leak detector: raises on leak
    stats["pool_stats"] = eng.pool_stats()
    return {r.uid: tuple(r.output) for r in done}, stats


@pytest.mark.parametrize("case", list(CASES))
def test_engine_matches_jax_engine(runs, case):
    """Same tokens, same telemetry, same counters and frame-pool stats,
    clean shutdown."""
    model, ref_out, ref_stats = runs[case]
    out, stats = _serve_trace(model, CASES[case])
    assert out == ref_out
    assert len(out) == TRACE["n_requests"]
    assert stats["telemetry"] == ref_stats["telemetry"]
    assert stats["pool_stats"] == ref_stats["pool_stats"]
    assert stats["pool_stats"]["live_seqs"] == 0     # a BlockManager's stats
    assert stats == ref_stats
    assert stats["leaked_frames"] == 0
    if case == "pooled-swap-retain":
        assert stats["swapped"] > 0 and stats["shared_prompt_tokens"] > 0


@pytest.mark.parametrize("case", list(CASES))
def test_fused_matches_stepwise(runs, case):
    """Fusion changes who drives the loop, never what it computes
    (tests/test_fused_decode.py:46): tokens, telemetry and decode steps
    equal, strictly fewer dispatches."""
    model = runs[case][0]
    fused, st_f = _serve_trace(model, CASES[case], max_fused_steps=8)
    step, st_s = _serve_trace(model, CASES[case], max_fused_steps=1)
    assert fused == step
    assert st_f["telemetry"] == st_s["telemetry"]
    assert st_f["decode_steps"] == st_s["decode_steps"]
    assert st_f["dispatches"] < st_s["dispatches"]


def test_fused_eos_early_exit(runs):
    """EOS ends a fused run from the fed-back token; the predicated-out
    iterations leave no trace (tests/test_fused_decode.py:254)."""
    model = runs["pooled-swap-retain"][0]
    prompt = np.random.default_rng(0).integers(0, 64, 4).astype(np.int32)

    def serve(**kw):
        with ServeEngine(model, EngineConfig(slots=1, max_len=MAX_LEN,
                                             **kw)) as eng:
            sched = Scheduler(eng)
            sched.submit([Request(uid=0, prompt=prompt, max_new_tokens=12)])
            done = sched.run()
        stats = eng.shutdown()
        return tuple(done[0].output), stats

    base, _ = serve(max_fused_steps=1)
    eos = int(base[2])
    cut = base.index(eos) + 1
    fused, st_f = serve(max_fused_steps=16, eos_id=eos)
    step, st_s = serve(max_fused_steps=1, eos_id=eos)
    assert fused == step == base[:cut]
    assert st_f["telemetry"] == st_s["telemetry"]
    assert st_f["decode_steps"] == st_s["decode_steps"] == len(prompt) + cut
