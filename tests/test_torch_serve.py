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


# -- BlockManager: a restored donor offers only the pages it maps --------------
def _managers(module, kinds=("tree", "linear")):
    """tests/test_prefix_index.py's managers (14 frames, 3 sequences, 6
    pages of 2 slots, retention and spill) from ``module``."""
    class NullIO:
        def read(self, frames):
            return [("pg", int(f)) for f in frames]

        def write(self, assignments):
            pass
    out = []
    for kind in kinds:
        bm = module.BlockManager(
            n_frames=14, n_seqs=3, max_lpages=6, page_slots=2,
            policy="on_demand", share_prefixes=True, retain_frames=8,
            n_spill_frames=4, prefix_index=kind)
        bm.page_io = NullIO()
        out.append(bm)
    return out


_BASES = [np.arange(12, dtype=np.int32),
          np.concatenate([np.arange(6, dtype=np.int32),
                          np.arange(20, 26, dtype=np.int32)]),
          np.arange(100, 112, dtype=np.int32)]


def _observe(mgrs):
    """What tests/test_prefix_index.py's _observe compares, across any
    managers (either package's): matches, admission costs, stats, the
    allocator's free list and the block tables."""
    import dataclasses
    probes = [b[:k] for b in _BASES for k in (3, 7, 12)]
    seen = []
    for m in mgrs:
        stats = dict(m.stats())
        stats.pop("prefix_index")
        seen.append(([m._match_prefix(p) for p in probes],
                     [dataclasses.astuple(m.admission_cost(p))
                      for p in probes], stats, list(m.allocator._free),
                     m.block_table.tolist()))
    assert all(s == seen[0] for s in seen[1:])


def _drive(mgrs, ops):
    """tests/test_prefix_index.py::test_tree_linear_differential's op
    stream on every manager in lockstep: each op's result and any
    OutOfFrames the same on all, every observable after every op, and a
    leak-free shutdown."""
    live, grown, swapped = {}, {}, set()

    def every(fn):
        outs, errs = [], []
        for m in mgrs:
            try:
                outs.append(fn(m))
                errs.append(None)
            except RuntimeError as e:          # OutOfFrames of either package
                assert type(e).__name__ == "OutOfFrames", e
                outs.append(None)
                errs.append("OutOfFrames")
        assert all(e == errs[0] for e in errs) and all(
            o == outs[0] for o in outs), (outs, errs)
        return outs[0], errs[0]

    for x in ops:
        op, seq, val = (x >> 2) % 6, x % 3, x >> 5
        if op == 0 and seq not in live and seq not in swapped:
            prompt = _BASES[val % 3][:2 + val % 11].copy()

            def begin(m, s=seq, p=prompt):
                n = m.begin_seq(s, p)
                for pos in range(min(n, len(p) - 1), len(p)):
                    m.ensure_writable(s, pos)
                return n
            _, err = every(begin)
            if err is None:
                live[seq], grown[seq] = prompt, len(prompt)
            else:
                every(lambda m, s=seq: m.release_seq(s))
        elif op == 1 and seq in live and grown[seq] < 12:
            _, err = every(lambda m, s=seq, p=grown[seq]:
                           m.ensure_writable(s, p))
            if err is None:
                grown[seq] += 1
        elif op == 2 and seq in live:
            every(lambda m, s=seq, c=val % 2: m.release_seq(s, completed=c))
            del live[seq], grown[seq]
        elif op == 3 and seq in live:
            pages, _ = every(lambda m, s=seq: m.evict_seq(s, s))
            if pages is not None:
                del live[seq]
                swapped.add(seq)
        elif op == 4 and seq in swapped and seq not in live:
            prompt = _BASES[val % 3][:4].copy()
            _, err = every(lambda m, s=seq, p=prompt:
                           m.restore_seq(s, s, tokens=p))
            if err is None:
                swapped.discard(seq)
                live[seq], grown[seq] = prompt, 12
        elif op == 5:
            for m in mgrs:
                m.share_prefixes = bool(val % 2)
        _observe(mgrs)
    for s in list(live):
        every(lambda m, q=s: m.release_seq(q, completed=True))
    _observe(mgrs)
    assert all(m.shutdown() == 0 for m in mgrs)


#: the stream on which the reference's tree and linear managers assert:
#: sequence 1 (prompt [0, 1], one page) is evicted and restored with the
#: 4-token tokens=[0, 1, 2, 3]; sequence 0's prompt [0, 1, 2] then matches
#: 3 tokens of it, 2 pages, and the donor maps only page 0
UNMAPPED_DONOR = [1, 1, 1, 1, 1, 10525, 16, 48]


@pytest.mark.parametrize("stream", ["unmapped-donor", "reference-survives"])
def test_restored_donor_offers_only_its_pages(stream):
    """The port's tree and linear BlockManagers stay identical in every
    observable and leak-free on the stream that makes the reference's
    assert on an unmapped donor page (the port records a restored
    sequence's tokens only as far as its pages map them; the reference
    is checked to still assert there); on a seeded stream the reference
    survives, both port managers equal the reference's in every
    observable after every op."""
    from repro.emem_vm import block_manager as jax_bm
    from repro_torch.emem_vm import block_manager as port_bm
    if stream == "unmapped-donor":
        with pytest.raises(AssertionError, match="live"):
            _drive(_managers(jax_bm), UNMAPPED_DONOR)
        _drive(_managers(port_bm), UNMAPPED_DONOR)
    else:
        ops = np.random.default_rng(7).integers(0, 2 ** 16, 48).tolist()
        _drive(_managers(jax_bm, ("tree",)) + _managers(port_bm), ops)
