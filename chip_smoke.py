#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Builds the port's CUDA kernels from ``src/repro_torch`` and drives the
port's serving paths at the full width of qwen3-0.6b (random weights from a
seed): the pooled KV memory (K1, K2), full-sequence prefill (K3) and the
batch KV layout (K4); then the Mamba2 family at the full width of
mamba2-780m: prefill through the SSD scan (K5) and recurrent-state serving;
then the emulated memory itself at the reference's production scale (2^24
slots of 128 f32, 8 GiB): EMem reads and writes through the slot gather
(K7) and EMemVM, whose whole-page reads go through the page gather (K6);
then the serving-memory benchmark (``benchmarks/vm_bench_torch.py``) at
qwen3-0.6b (K1, K2, K6, K7); then the reference's other decoder archs
(granite-3-2b, h2o-danube-1.8b, qwen2-moe-a2.7b, qwen2-72b, mixtral-8x7b,
jamba-v0.1-52b) at their published widths, served through K1 and K2, with
K3 and K5 in their prefills.  Each phase prints one JSON line with its
seconds (phase archs one per arch):

1. build      -- nvcc builds the five kernel libraries from the checkout's
                 sources, all at once: paged decode (K1, whose entries are
                 paged_qkv_write, the decode path's, and paged_kv_write,
                 the TPU kernel's function; K2 paged_gather_attend), K3
                 flash_attention, K4 flash_decode, K5 ssd, and the gathers
                 (K6 gather_pages, K7 gather_slots);
2. kernels    -- K1 and K2 each against its plain PyTorch version (the
                 composed oracle, ``kernels/paged_decode/ref.py``) at the
                 main path's shapes (f32 and bf16, 1 and 2 emulated shards,
                 window None and 64), at other head groups, head dims and
                 page sizes, and at K2's split edges (lengths 1, 63, 64, 65,
                 511, 512 on 16- and 256-slot pages, a window of 40 that
                 starts inside a split, on 2 shards a row that one shard
                 owns none of and a split that holds only the other
                 shard's frames), with two K2 launches bit for bit and its
                 counters back at zero; K1's decode entry, which also does
                 the q/k RMS norm and rotary, against ``ref.qkv_write`` at
                 the main path's shapes (f32 and bf16, 1 and 2 shards,
                 qk_norm on and off, a masked, an empty, an unmapped and a
                 read-only row) and at the other head dims: q and K rows
                 within QKV_RTOL (bit for bit without qk_norm), V rows,
                 drops and untouched slots bit for bit, two launches bit
                 for bit, and with its write off
                 against ``ref.qk_rotate``; times of both kernels, K1's old
                 entry, the plain composites and the least time the card
                 could take (bound);
3. teacher    -- 64 teacher-forced full-width decode steps with the kernels
                 and with the composed oracle, same weights and tokens:
                 logits agree within the stated tolerance (f32 and bf16);
   profile    -- where a full-width bf16 decode step's time goes (pooled
                 and batch layouts): wall ms per step, device ms per step
                 by kernel and device ops per step (torch.profiler), and
                 one step's device time on the queued-event clock beside
                 the profiler's (None where a step's launches overflow
                 the card's launch queue);
4. serve      -- the full-width engine + scheduler serve a seeded trace in
                 bf16; every request completes, shutdown is leak-free, a
                 swap preemption and prefix sharing happen, and every decode
                 step of every layer launched both kernels;
5. tokens     -- the same trace in f32 gives identical per-uid tokens with
                 the kernels and with the composed oracle;
6. flash      -- K3 against ref.mha and K4 against the plain branch of
                 flash_ops.decode_attention_partial, at the prefill and
                 batch-serving shapes (f32 and bf16, windows None and 64,
                 tail queries, head groups 1, 2 and 4, head dims 64 and 128,
                 S = 200): K3 through the variant its wrapper picks (the
                 tensor cores in bf16 at D 64 and 128), the CUDA-core
                 variant forced at the prefill shape, a bf16 head dim of 96
                 that goes to the CUDA cores by choice and that a forced
                 tensor-core launch refuses; K4 at its split edges (lengths
                 63, 64, 65, 512, a window across an edge, S = 200) and two
                 launches bit for bit; kernel / plain / library / bound
                 times, and SDPA's own error against ref.mha beside K3's;
7. prefill    -- full-width Model.prefill of 8 prompts of 511 tokens with
                 the kernel (attn_impl "pallas") and with the plain oracle
                 ("ref"), f32 and bf16: logits and K/V cache agree, the bf16
                 prefill runs K3 on the tensor cores once per layer, and in
                 f32 prefill(510) plus one batch-layout decode step (K4)
                 reproduces prefill(511)'s logits;
8. batch      -- the full-width engine + scheduler serve the phase-4 trace
                 on the batch KV layout with attn_impl "pallas": in bf16
                 every decode step of every layer launched K4 and K1 with
                 its page write off (the q/k norm and rotary); in f32 the
                 per-uid tokens equal the plain path's;
9. ssd        -- K5 against its plain version (``ref.ssd_chunked``) at the
                 prefill's shape (Bt 8, S 512, H 48, P 64, N 128, G 1,
                 chunk 128), at S = 200 and 511 with G = 2 and chunk 64, at
                 the smoke config's widths (P 32, N 16, chunk 8), with a
                 chunk of 100 and at three narrower widths (SSD_NARROW),
                 f32 and bf16: y and the final state, each through the
                 variant the wrapper picks (the tensor cores in bf16 at
                 all but the smoke widths and chunk 100), the CUDA-core
                 variant forced
                 at the prefill shape, a forced tensor-core launch refusing
                 the last two shapes, two tensor-core launches bit for bit;
                 kernel (both variants, bf16 and f32) / plain / bound times;
10. ssm_prefill -- full-width mamba2-780m Model.prefill of 8 x 512 and
                 8 x 511 tokens with K5 (attn_impl "pallas") and with its
                 plain version ("ref"), f32 and bf16: K5 once per layer, in
                 bf16 on the tensor cores; layer 0's conv/ssd cache and the
                 logits (f32: every layer's cache too) agree
                 (SSM_ORDER_FACTOR); in bf16 K5 on the real inputs of
                 the first 4 layers against its plain version, and layer
                 0's ssd cache more tightly, each gate failing bf16
                 operands alone; in f32 prefill(510) plus one decode
                 step reproduces prefill(511); in bf16 the device time of a
                 steady prefill and K5's share, with K5 on the tensor cores
                 and forced to the CUDA cores;
11. ssm_serve  -- the full-width mamba2-780m engine + scheduler serve the
                 phase-4 trace on the batch layout in bf16 (its decode is
                 the recurrent step, plain torch; no kernel launches), a
                 profiled decode step gives the device busy share, and in
                 f32 fused and stepwise runs serve identical tokens;
12. gather    -- K7 and K6 against their plain versions bit for bit: the
                 reference tests' sweep shapes, rows of 1, 3 and 4
                 elements, f32, bf16, int32 and uint8 stores, empty,
                 repeated and past-the-end indices, a store offset by one
                 row, pages that K6's chunks do not divide; then on the 8
                 GiB store in f32 and bf16 65536 slots and 1, 16 and 4096
                 pages; kernel / plain / library / bound times;
13. emem      -- random read/write of the 8 GiB store as 1 and as 16
                 emulated shards, 4096 requests per shard at capacity
                 factor 1.5 (a write batch repeats addresses), equal to
                 read_ref/write_ref on a logical copy; at 16 shards and
                 factor 1.0 the drops are exactly _plan's; us per batch,
                 requests/s and GB/s; a pointer chase of 1024 dependent
                 hops, one K7 launch each, ns per hop; device times on
                 the queued-event clock where nothing syncs, with the
                 profiler's records of 1, 10 and 100 one-shard reads;
14. vm        -- EMemVM over the 8 GiB spec, sharded at 1 and 16 shards,
                 caches of 0 and 16 sets: a seeded sequence of vwrite /
                 vread, unmap / remap, protection, swap-outs that spill,
                 faults under a full pool, flush, bit-identical to an
                 unsharded twin whose gathers take the plain route (the
                 single-view read_ref/write_ref); every vread launched
                 K7 once and K6 once per cache fill and swap-out; vread /
                 vwrite us and the hit rate;
15. vm_bench  -- benchmarks/vm_bench_torch.py's workloads with the
                 reference's traffic at qwen3-0.6b's full width in f32:
                 every reference assertion but the dispatch wall
                 criterion, which is reported, and the sweep's exact m,
                 held to 1e-5; K1 and K2 launched once per
                 layer and decode step in each pooled or reserved
                 section, both in the sweep, K6 and K7 in the EMemVM
                 rows; each headline beside the CPU one of BENCH_vm.json;
16. archs     -- each of ARCHS_LAYERS's six archs in bf16 at its published
                 widths, cut in depth only where 80 GB cannot hold it (the
                 cut as ``reduced`` on its line), one at a time: a
                 4-request trace of the serve phase's settings through
                 the engine + scheduler on
                 the pooled layout (every request completed, no frame
                 leaked, K1 and K2 once per attention layer and decode
                 step); 16 teacher-forced steps on 4-slot pages with K1
                 and K2 held to the composed oracle on each step's real
                 inputs, and the logits of one step from the same
                 history and expert choices within phase teacher's bf16
                 tolerance or, where larger, ORDER_FACTOR times the
                 oracle's own disagreement across two summation orders
                 (the free-running comparison reported beside it); a
                 profiled decode step (wall and device ms beside the
                 weights' read bound); granite's and danube's bf16 prefill
                 through K3 (D 64 on the tensor cores, D 80 on the CUDA
                 cores) against the plain path, and K3 against ref.mha at
                 their shapes; jamba's through K5 at state 16, and K5 on
                 the real inputs of its 7 Mamba2 layers.

Then it prints the kernels' JSON line, the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``.  Any failed check
raises, and the script exits non-zero without a CUDA device or without the
repository's ``src/repro_torch`` beside it.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
F32_FLOPS_PER_S = 67e12            # H100 SXM float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12          # H100 SXM dense bf16 tensor cores

# phase 2 shapes: the main path's (qwen3-0.6b: 8 KV heads of 128, 2 query
# heads per KV head; 16-slot pages; 8 slots x 512 tokens of table)
B, HKV, G, D, PS, MAX_LP = 8, 8, 2, 128, 16, 32
# tolerances, kernel against plain (both compute in f32 from the same
# inputs, summing in another order): pages byte-equal; acc and l within
# rtol 1e-5 + atol 1e-5; m (a max of q.k products) within atol 1e-5
K2_RTOL, K2_ATOL, M_ATOL = 1e-5, 1e-5, 1e-5
# K1's decode entry (paged_qkv_write) at qwen3-0.6b's rotary base and norm
# eps; against its plain version (ref.qkv_write, the same f32 arithmetic
# with the norm's sum of squares in another order): with qk_norm, q and the
# written K rows within rtol/atol 1e-5 in f32 and one bf16 rounding step
# (2^-7 |x|) in bf16; without it, where the two share every rounding point,
# bit for bit; V rows, dropped writes and untouched slots bit for bit
QKV_THETA, QKV_EPS = 1e6, 1e-6
QKV_RTOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
QKV_ATOL = {"float32": 1e-5, "bfloat16": 0.0}
# teacher-forced logits, kernels against composed, relative to max |logit|
# over the run: f32 1e-3, which with phase 2 carries correctness; bf16
# 5e-2, a smoke check of the bf16 path only (one bf16 rounding of an
# attention output that lands on the other side of a tie moves a logit by
# ~2^-8 of its size, and 28 layers and 64 steps of cache carry it on)
LOGIT_RTOL = {"float32": 1e-3, "bfloat16": 5e-2}
# phase archs' teacher: one step from the same history and expert choices,
# kernels against the composed oracle, within LOGIT_RTOL or, where larger,
# ORDER_FACTOR times the oracle's own disagreement when it sums in another
# order (the rule phase ssm_prefill's gates follow, SSM_ORDER_FACTOR)
ORDER_FACTOR = 4
# phase 6, kernel against plain (both compute in f32 from the same inputs,
# summing in another order): f32 outputs within atol 1e-5 + rtol 1e-5;
# bf16 outputs within atol 1e-5 plus one bf16 rounding step (2^-7 of |x|),
# since both round an f32 result that may differ in its last bits; K4's m
# within atol 1e-5 and l within rtol 1e-5 + atol 1e-5
FLASH_RTOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
FLASH_ATOL = 1e-5
# phase 7: 8 prompts of 511 tokens into a 512-position batch cache
PREFILL_B, PREFILL_S, PREFILL_MAX_LEN = 8, 511, 512
# phase 9: K5 at the prefill's shape (mamba2-780m, 8 prompts of 512 tokens)
SSD_SHAPE = dict(bt=8, s=512, h=48, p=64, n=128, g=1, chunk=128)
# K5 against plain (both compute in f32 from the same inputs, summing in
# another order): f32 y and state within rtol/atol 1e-4; bf16 y within one
# bf16 rounding step (2^-7 |y|) + 1e-4, since both round an f32 result that
# may differ in its last bits, and the f32 state within rtol/atol 1e-3
SSD_TOL = {"float32": (1e-4, 1e-4, 1e-4), "bfloat16": (2.0 ** -7, 1e-4, 1e-3)}
# phase 9's narrower K5 cases (P, N, chunk, S, H, G): bf16 takes them to the
# tensor cores' run-time instance, each with a tail chunk
SSD_NARROW = ((32, 64, 32, 200, 8, 2), (16, 16, 16, 37, 4, 1),
              (48, 96, 48, 100, 6, 3))
# phase 10, the kernel path against the plain path (attn_impl "ref": K5's
# plain version, the same 128-row chunks) over 48 random-weight layers:
# layer 0 (the same inputs to both) within LOGIT_RTOL of max |value|; the
# logits (f32: and every layer's cache) within LOGIT_RTOL or, where
# larger, SSM_ORDER_FACTOR times the plain path's own disagreement with
# itself at half the chunk, in the same dtype.  The random weights drive
# dt * A to cumulative sums near 1e4 inside a chunk, where f32 resolves
# ~1e-3, so any change of summation order moves the decays by ~1e-4
# relative per layer and 48 layers carry it to ~1e-2: the same for the
# kernel as for a second plain order (this phase on an NVIDIA H100 at 700
# W: the plain path at chunk 64 against 128 differs by 6.8e-3 in the
# logits, the kernel path by 1.4e-2, while layer 0 agrees within 6.3e-5).
# In bf16 every layer also rounds its activations, and the plain path's
# own half-chunk disagreement reaches ~0.6 of max |logit| (same card), so
# the logits only bound the drift and cannot see K5.  K5 is held there by
# layer 0's ssd cache within SSM_ORDER_FACTOR times the plain path's own
# half-chunk disagreement at layer 0 (same card: plain 7.5e-5, the kernel
# 6.4e-5, bf16 operands alone 2.9e-3), and on the real inputs of the
# first SSM_REAL_LAYERS layers (ssm_k5_real).
SSM_ORDER_FACTOR = 4
SSM_REAL_LAYERS = 4

SERVE_ENGINE = dict(slots=8, max_len=512, max_fused_steps=8, retain_frames=16)
# 32 frames of 16 slots: a 194-token prompt with 48 new tokens needs 16
# frames, so long requests running together overflow the pool and swap (6
# swaps under this trace; 96 frames never preempt under it)
SERVE_POOL = 32
SERVE_TRACE = dict(seed=0, n_requests=16, arrival_rate=0.25, zipf_alpha=1.2,
                   prompt_len_short=32, prompt_len_long=192, out_len_short=16,
                   out_len_long=48, vocab_size=151936)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls, CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, iters: int = 20, warmup: int = 3):
    """Device time of ``fn()`` from torch.profiler: (ms per call summed over
    every kernel and copy it ran, {kernel name: ms per call} plus
    ``device_ops_per_call``, the kernels and copies per call); (None, {})
    when the profiler records no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    launches = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
            launches += 1
    total = sum(by_name.values())
    if total <= 0:
        return None, {}
    out = {k: v / iters / 1e3 for k, v in by_name.items()}
    out["device_ops_per_call"] = launches / iters
    return total / iters / 1e3, out


def queued_ms(fn, iters: int = 50, warmup: int = 5,
              sleep_cycles: int = 50_000_000):
    """Device time per call of ``fn()``: CUDA events around ``iters`` calls
    queued behind a sleep kernel (``sleep_cycles`` clocks, ~25 ms by
    default), so that the device runs them back to back whatever the host's
    launch overhead.  None when the device reached the first event before
    the host had queued every call (``fn`` synchronises with the host, or
    the host is slower than the sleep)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    late = start.query()
    torch.cuda.synchronize()
    return None if late else start.elapsed_time(end) / iters


def timed(fn, iters: int = 50) -> dict:
    """A function's device time per call (``device_ms``): the queued-event
    clock, or the profiler's device time where ``fn`` synchronises with the
    host; beside it every clock read (the profiler's, which under-counted
    long kernels in some runs, and the CUDA-event time of a plain loop of
    calls, which is the Python wrapper's time when a call is shorter than
    its wrapper)."""
    queued = queued_ms(fn, iters=iters)
    prof_ms, _ = device_profile(fn, iters=min(iters, 20))
    return {"device_ms": queued if queued is not None else prof_ms,
            "clock": "events" if queued is not None else "profiler",
            "queued_ms": queued, "profiler_ms": prof_ms,
            "loop_ms": cuda_ms(fn, iters=iters)}


def launch_queue_ms(dev, counts=(960, 1000, 1024, 1100)) -> dict:
    """Host ms to launch ``n`` tiny kernels behind a ~0.2 s sleep kernel,
    for each ``n``: a few ms while the card's launch queue has room, the
    sleep's length once it is full and the host waits for the card."""
    import torch
    x = torch.zeros(16, device=dev)
    x.add_(1)                                   # loaded before the sleep
    out = {}
    for n in counts:
        torch.cuda.synchronize()
        torch.cuda._sleep(400_000_000)
        t = time.perf_counter()
        for _ in range(n):
            x.add_(1)
        out[n] = (time.perf_counter() - t) * 1e3
        torch.cuda.synchronize()
    return out


def profiler_records(fn, iters: int) -> int:
    """Device records torch.profiler kept over ``iters`` calls of ``fn``."""
    _, by_name = device_profile(fn, iters=iters)
    return round(by_name.get("device_ops_per_call", 0) * iters)


def mk_vm(rng, b, max_lp, ps, lengths, shared_page0):
    """Scrambled BlockManager-style tables (distinct frames per live page),
    optionally one read-only frame backing page 0 of every sequence."""
    n_frames = b * max_lp
    bt = np.full((b, max_lp), -1, np.int32)
    fl = np.zeros((n_frames,), np.int32)
    fr = np.zeros((n_frames,), bool)
    free = list(rng.permutation(n_frames))
    sh = None
    if shared_page0:
        sh = int(free.pop())
        fl[sh], fr[sh] = 0, True
    for s in range(b):
        for lp in range(-(-int(lengths[s]) // ps)):
            if sh is not None and lp == 0:
                bt[s, 0] = sh
                continue
            f = int(free.pop())
            bt[s, lp], fl[f] = f, lp
    return bt, fl, fr


# -- phase 2 -------------------------------------------------------------------

def kernel_case(seed, dtype, dev, g=G, d=D, ps=PS, max_lp=MAX_LP,
                lengths=None):
    """Phase-2 inputs: ragged lengths with an empty row 1 and a write to
    page 0 in row 2, and scrambled tables with a read-only page 0; or the
    given ``lengths`` (row 1 empty) over the tables of
    :func:`parity_tables`."""
    import torch
    rng = np.random.default_rng(seed)
    if lengths is None:
        lengths = rng.integers(1, max_lp * ps + 1, B).astype(np.int32)
        lengths[1], lengths[2] = 0, min(7, ps)   # an empty row; a write to page 0
        bt, fl, fr = mk_vm(rng, B, max_lp, ps, lengths, shared_page0=True)
    else:
        lengths = np.asarray(lengths, np.int32)
        bt, fl, fr = parity_tables(rng, max_lp, ps, lengths)
    wm = np.ones(B, bool)
    wm[5] = False
    n_frames = B * max_lp

    def t(a, dt=None):
        return torch.tensor(a, device=dev, dtype=dt)
    return dict(
        q=t(rng.normal(size=(B, HKV * g, d)).astype(np.float32), dtype),
        k_new=t(rng.normal(size=(B, HKV, d)).astype(np.float32), dtype),
        v_new=t(rng.normal(size=(B, HKV, d)).astype(np.float32), dtype),
        kp=t(rng.normal(size=(n_frames, ps, HKV, d)).astype(np.float32), dtype),
        vp=t(rng.normal(size=(n_frames, ps, HKV, d)).astype(np.float32), dtype),
        bt=t(bt), fl=t(fl), lengths=t(lengths), fr=t(fr), wm=t(wm), group=g,
        max_pages=max_lp, lengths_np=lengths, bt_np=bt, wm_np=wm, fr_np=fr)


def parity_tables(rng, max_lp, ps, lengths):
    """Tables for two emulated shards (shard = frame % 2): row 3's frames
    all even, so shard 1 owns none of them; row 4's pages that hold its
    first K2 split (positions below 64) even and the rest odd, so shard
    1's first split of that row attends nothing while its others do; the
    other rows' frames drawn from either.  No read-only frame."""
    n_frames = B * max_lp
    pools = [list(rng.permutation(np.arange(par, n_frames, 2)))
             for par in (0, 1)]
    bt = np.full((B, max_lp), -1, np.int32)
    fl = np.zeros((n_frames,), np.int32)
    for b in range(B):
        for lp in range(-(-int(lengths[b]) // ps)):
            if b == 3 or (b == 4 and lp * ps < K2_SPLIT):
                par = 0
            elif b == 4:
                par = 1
            else:
                par = int(rng.integers(2)) if pools[0] and pools[1] else \
                    int(not pools[0])
            f = int(pools[par].pop())
            bt[b, lp], fl[f] = f, lp
    return bt, fl, np.zeros((n_frames,), bool)


def k1_writers(x, n_shards, sid, bt=None):
    """(rows whose K/V row K1 writes on shard ``sid``, bytes of the table
    words K1 reads on these inputs: each row's length and write-mask flag;
    for a row that passes those, its block-table word and, for a mapped
    frame, that frame's read-only flag)."""
    bt = x["bt_np"] if bt is None else bt
    ps, max_lp = x["kp"].shape[1], bt.shape[1]
    n_frames = len(x["fr_np"])
    rows, nbytes = [], B * (4 + 1)
    for b in range(B):
        ln = int(x["lengths_np"][b])
        if not x["wm_np"][b] or ln <= 0 or (ln - 1) // ps >= max_lp:
            continue
        nbytes += 4
        f = int(bt[b, (ln - 1) // ps])
        if not 0 <= f < n_frames:
            continue
        nbytes += 1
        if not x["fr_np"][f] and f % n_shards == sid:
            rows.append(b)
    return rows, nbytes


def k1_qkv_work(x, c):
    """(bytes, f32 operations) of K1's decode entry on one shard: q and the
    norm weights read once, q written once, the table words, and for the
    rows it writes their k and v read once and their K/V rows written; per
    element 4 operations for the norm (square, sum, scale, weight) and 3
    for the rotary, per rotary pair a power, a cosine and a sine, over q
    and the written rows' k."""
    es, es_kv = c["q"].element_size(), x["kp"].element_size()
    d = c["q"].shape[2]
    hq, hkv = c["q"].shape[1], c["k"].shape[1]
    rows, nbytes = k1_writers(x, 1, 0, c["bt_np"])
    nbytes += (B * 2 * hq * d * es + len(rows) * 2 * hkv * d * (es + es_kv)
               + 2 * d * es)
    ops = (B * hq + len(rows) * hkv) * (7 * d + 3 * d // 2)
    return nbytes, ops


def k2_work(x, n_shards, sid, window):
    """(bytes, f32 operations) K2 must spend on these inputs: each attended
    (frame, slot) K and V row read once however many sequences share it,
    q, the lengths and the block-table entries it walks read once,
    (acc, m, l) written once; 4*G*D operations per attended position and
    KV head (q.k and p.v)."""
    es_kv, es_q = x["kp"].element_size(), x["q"].element_size()
    rows, entries, ops = set(), 0, 0
    for b in range(B):
        ln = int(x["lengths_np"][b])
        lo = max(0, ln - window) if window else 0
        if ln > lo:
            entries += (ln - 1) // PS - lo // PS + 1
        for pos in range(lo, ln):
            f = int(x["bt_np"][b, pos // PS])
            if f >= 0 and f % n_shards == sid:
                rows.add((f, pos % PS))
                ops += 4 * G * D * HKV
    nbytes = (2 * len(rows) * HKV * D * es_kv + B * HKV * G * D * es_q
              + 4 * entries + 4 * B + B * HKV * G * (D + 2) * 4)
    return nbytes, ops


def check_shard(x, sid, n_shards, window, use_vm, err, what):
    """Both kernels (``ops.paged_decode_shard``'s fused impl: K1's decode
    entry with the norm and rotary off, then K2) against their plain
    versions (its composed impl) on one emulated shard, and K1's
    ``paged_kv_write`` entry alone: pages byte-equal, (acc, m, l) within the
    stated tolerance.  Raises on a
    mismatch, folds max errors into ``err``; returns the fused outputs."""
    import torch
    from repro_torch.kernels.paged_decode import kernel as K
    from repro_torch.kernels.paged_decode import ops
    kp = x["kp"][sid::n_shards].contiguous()
    vp = x["vp"][sid::n_shards].contiguous()
    outs = {impl: ops.paged_decode_shard(
        x["q"], x["k_new"], x["v_new"], kp.clone(), vp.clone(), x["lengths"],
        x["bt"], x["fl"], x["fr"], x["wm"], sid=sid, n_shards=n_shards,
        head_start=0, group=x["group"], window=window,
        max_pages=x["max_pages"], use_vm=use_vm, impl=impl)
        for impl in ("fused", "composed")}
    torch.cuda.synchronize()
    f, c = outs["fused"], outs["composed"]
    if not (torch.equal(f[3], c[3]) and torch.equal(f[4], c[4])):
        raise AssertionError(f"K1 pages differ from plain: {what} sid={sid}")
    # K1's TPU-function entry alone (the fused impl runs its decode entry)
    bt, fr = ((x["bt"], x["fr"]) if use_vm else
              ops._identity_tables(B, x["max_pages"], kp.device))
    old = K.paged_kv_write(x["k_new"], x["v_new"], kp.clone(), vp.clone(), bt,
                           x["lengths"], fr, x["wm"], (sid, n_shards, 0))
    torch.cuda.synchronize()
    if not (torch.equal(old[0], c[3]) and torch.equal(old[1], c[4])):
        raise AssertionError(f"K1 paged_kv_write differs from plain: {what} "
                             f"sid={sid}")
    for name, a, r in zip("acc m l".split(), f[:3], c[:3]):
        dlt = (a - r).abs()
        e = dlt.max().item()
        err["k2"] = max(err["k2"], e)
        tol = M_ATOL if name == "m" else K2_ATOL + K2_RTOL * r.abs()
        if not bool((dlt <= tol).all()):
            raise AssertionError(f"K2 {name} differs from plain by {e}: "
                                 f"{what} sid={sid}")
    if n_shards == 1 and torch.equal(f[3], kp):
        raise AssertionError(f"K1 wrote nothing: {what}")
    return f


def check_case(x, n_shards, window, err, empty=None):
    """Every emulated shard of one input set; row 1 is empty and must come
    out exactly (acc, m, l) = (0, -1e30, 0), and so must the rows
    ``empty[sid]`` on shard ``sid`` (rows whose frames it does not own)."""
    what = (f"{x['kp'].dtype} G={x['group']} D={x['q'].shape[2]} "
            f"slots={x['kp'].shape[1]} S={n_shards} window={window}")
    for sid in range(n_shards):
        acc, m, l = check_shard(x, sid, n_shards, window, True, err, what)[:3]
        for row in (1, *(empty or {}).get(sid, ())):
            if not (bool((m[row] == -1e30).all()) and bool((l[row] == 0).all())
                    and bool((acc[row] == 0).all())):
                raise AssertionError(f"K2: row {row} of shard {sid} is not "
                                     f"(0, -1e30, 0): {what}")


def check_k2_launch(x, n_shards, window):
    """K2 alone on each shard of ``x``: two launches on the same inputs give
    the same bits, and the launch leaves its counters at zero."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_decode import kernel as K
    b, hq, d = x["q"].shape
    qg = x["q"].reshape(b, HKV, hq // HKV, d)
    for sid in range(n_shards):
        kp = x["kp"][sid::n_shards].contiguous()
        vp = x["vp"][sid::n_shards].contiguous()
        runs = [K.paged_gather_attend(qg, kp, vp, x["bt"], x["lengths"],
                                      (sid, n_shards, 0), window=window)
                for _ in range(2)]
        torch.cuda.synchronize()
        if not all(torch.equal(a.view(torch.int32), c.view(torch.int32))
                   for a, c in zip(*runs)):
            raise AssertionError(f"K2: two launches differ (shard {sid} of "
                                 f"{n_shards}, {x['kp'].dtype}, window "
                                 f"{window})")
        count = build.counter_buffer(K.LIBRARY, x["q"].device, b * HKV)
        if bool(count.any()):
            raise AssertionError("K2 left a counter above zero")


#: other head groups, head dims and page sizes the kernels take: (G, D,
#: page_slots, max_lpages), each in f32 and bf16, windows None and 5
OTHER_SHAPES = [(1, 64, 4, 16), (3, 80, 8, 8), (4, 256, 256, 2),
                (16, 32, 16, 4)]
#: positions per K2 block (build.SPLIT); lengths at its edges (row 1
#: empty, rows 3 and 4 long enough to span several splits), on 16-slot
#: pages and on 256-slot pages, where one page spans four splits; window
#: 40 starts inside a split in every row longer than 40
K2_SPLIT = 64
K2_EDGE_LENGTHS = [K2_SPLIT - 1, 0, 1, 511, 512, K2_SPLIT, K2_SPLIT + 1,
                   3 * K2_SPLIT + 17]
K2_EDGE_PAGES = ((PS, MAX_LP), (256, 2))


def bits(t):
    """A tensor's raw bits, for bit-for-bit comparisons."""
    import torch
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def qkv_case(x, norm: bool, g=G, seed=31):
    """Raw q/k/v projections for K1's decode entry, beside ``x``'s tables
    and lengths (row 1 empty, row 2 on the read-only frame, row 5 masked),
    with row 6's current page unmapped; random norm weights, or none."""
    import torch
    rng = np.random.default_rng(seed)
    dev, dtype = x["kp"].device, x["kp"].dtype
    d, ps = x["kp"].shape[3], x["kp"].shape[1]

    def t(shape, scale=1.0):
        a = rng.normal(size=shape).astype(np.float32) * scale
        return torch.tensor(a, device=dev).to(dtype)
    bt = x["bt_np"].copy()
    bt[6, max(int(x["lengths_np"][6]) - 1, 0) // ps] = -1
    return dict(q=t((B, HKV * g, d), 3.0), k=t((B, HKV, d), 3.0),
                v=t((B, HKV, d)), bt=torch.tensor(bt, device=dev), bt_np=bt,
                args=dict(q_norm=t((d,)) if norm else None,
                          k_norm=t((d,)) if norm else None, eps=QKV_EPS,
                          rope_theta=QKV_THETA))


def qkv_close(got, want, exact, err, what):
    """``got`` equal to ``want`` bit for bit where ``exact`` (no qk_norm),
    else within QKV_RTOL / QKV_ATOL; folds the max error into ``err["k1"]``
    and the share of elements that differ at all into
    ``err["k1_bits_differ"]``, keyed by dtype and qk_norm."""
    dt = str(want.dtype).split(".")[1]
    a, r = got.float(), want.float()
    dlt = (a - r).abs()
    e = dlt.max().item() if dlt.numel() else 0.0
    differ = (bits(got) != bits(want)).float().mean().item() \
        if dlt.numel() else 0.0
    key = f"{dt} qk_norm={not exact}"
    err["k1"] = max(err["k1"], e)
    err["k1_bits_differ"][key] = max(err["k1_bits_differ"].get(key, 0.0),
                                     differ)
    if exact and differ:
        raise AssertionError(f"K1 {what} differs from plain in {differ:.3g} "
                             f"of its elements (max {e}), not bit for bit")
    if not bool((dlt <= QKV_ATOL[dt] + QKV_RTOL[dt] * r.abs()).all()):
        raise AssertionError(f"K1 {what} differs from plain by {e}")


def check_qkv(x, c, n_shards, err, what):
    """K1's decode entry (``paged_qkv_write``) against ``ref.qkv_write`` on
    every emulated shard: q and the written K rows within QKV_RTOL (bit for
    bit without qk_norm), V rows,
    the dropped writes and every untouched slot bit for bit, exactly the
    rows K1's drop rules leave writing; two launches give the same bits;
    then the same launch with the write off (``qk_rotate``, the batch
    layout's) against ``ref.qk_rotate``."""
    import torch
    from repro_torch.kernels.paged_decode import kernel as K
    from repro_torch.kernels.paged_decode import ref
    what = f"{x['kp'].dtype} D={c['q'].shape[2]} {what}"
    exact = c["args"]["q_norm"] is None
    for sid in range(n_shards):
        kp = x["kp"][sid::n_shards].contiguous()
        vp = x["vp"][sid::n_shards].contiguous()
        outs = []
        for run in ("kernel", "kernel", "plain"):
            kpc, vpc = kp.clone(), vp.clone()
            if run == "plain":
                q = ref.qkv_write(c["q"], c["k"], c["v"], kpc, vpc,
                                  x["lengths"], c["bt"], x["fr"], x["wm"],
                                  sid=sid, n_shards=n_shards,
                                  max_pages=x["max_pages"], **c["args"])
            else:
                q = K.paged_qkv_write(c["q"], c["k"], c["v"], kpc, vpc,
                                      c["bt"], x["lengths"], x["fr"], x["wm"],
                                      (sid, n_shards, 0), **c["args"])
            outs.append((q, kpc, vpc))
        torch.cuda.synchronize()
        where = f"{what} shard {sid} of {n_shards}"
        if not all(torch.equal(bits(a), bits(b))
                   for a, b in zip(outs[0], outs[1])):
            raise AssertionError(f"K1: two launches differ: {where}")
        (kq, kk, kv), (pq, pk, pv) = outs[0], outs[2]
        if not torch.equal(bits(kv), bits(pv)):
            raise AssertionError(f"K1 V rows differ from plain: {where}")
        hit = (bits(pv) != bits(vp)).flatten(2).any(-1)    # written slots
        rows, _ = k1_writers(x, n_shards, sid, c["bt_np"])
        if int(hit.sum()) != len(rows):
            raise AssertionError(f"K1: {int(hit.sum())} slots written, "
                                 f"{len(rows)} expected: {where}")
        if not torch.equal(bits(kk[~hit]), bits(pk[~hit])):
            raise AssertionError(f"K1 touched a slot it must not: {where}")
        qkv_close(kq, pq, exact, err, "q: " + where)
        qkv_close(kk[hit], pk[hit], exact, err, "written K rows: " + where)
    kq, kk = K.qk_rotate(c["q"], c["k"], x["lengths"], **c["args"])
    pq, pk = ref.qk_rotate(c["q"], c["k"], x["lengths"], **c["args"])
    qkv_close(kq, pq, exact, err, "qk_rotate q: " + what)
    qkv_close(kk, pk, exact, err, "qk_rotate k: " + what)


def check_identity_tables(dev, err):
    """Without VM tables (the fixed layout: sequence b owns frames
    b*max_pages..) the fused path synthesizes identity tables; it must agree
    with the composed oracle's arithmetic mapping (f32, lengths >= 1, since
    the oracle's length-0 row wraps to the previous sequence's last page)."""
    import torch
    x = kernel_case(29, torch.float32, dev, max_lp=4)
    x["lengths"] = torch.tensor(np.maximum(x["lengths_np"], 1), device=dev)
    check_shard(x, 0, 1, None, False, err, "identity tables")


def phase_kernels(dev):
    import torch
    from repro_torch.kernels import build
    if build.SPLIT != K2_SPLIT:
        raise AssertionError(f"K2's split is {build.SPLIT}, not {K2_SPLIT}")
    err = {"k1": 0.0, "k1_bits_differ": {}, "k2": 0.0}
    timing = {}
    for dtype in (torch.float32, torch.bfloat16):
        for n_shards in (1, 2):
            for window in (None, 64):
                x = kernel_case(17, dtype, dev)
                check_case(x, n_shards, window, err)
                if dtype == torch.bfloat16 and n_shards == 1 and window is None:
                    timing = time_kernels(x)
            # K1's decode entry, qk_norm on and off
            for norm in (True, False):
                check_qkv(x, qkv_case(x, norm), n_shards, err,
                          f"qk_norm={norm}")
        for g, d, ps, max_lp in OTHER_SHAPES:
            x = kernel_case(23, dtype, dev, g=g, d=d, ps=ps, max_lp=max_lp)
            for window in (None, 5):
                check_case(x, 1, window, err)
            check_qkv(x, qkv_case(x, True, g=g), 1, err, f"G={g}")
        # K2's split edges; on two shards row 3 lies wholly on shard 0
        for ps, max_lp in K2_EDGE_PAGES:
            x = kernel_case(27, dtype, dev, ps=ps, max_lp=max_lp,
                            lengths=K2_EDGE_LENGTHS)
            for n_shards in (1, 2):
                for window in (None, 40):
                    check_case(x, n_shards, window, err,
                               empty={1: (3,)} if n_shards == 2 else None)
                    check_k2_launch(x, n_shards, window)
    check_identity_tables(dev, err)
    return err, timing


def time_kernels(x):
    """Kernel, plain and library times at the main path's shapes (bf16, one
    shard, no window): K1's decode entry beside its plain version, the ops
    it replaces on the decode path (the plain norm and rotary, then the old
    entry), the same launch with its write off and the old entry alone.  K2
    cycles over 8 copies of the page pool (8 x 17 MB, past the 50 MB L2),
    since the serving path finds each layer's pages cold."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_decode import kernel as K
    from repro_torch.kernels.paged_decode import ref
    meta = (0, 1, 0)
    shard = dict(sid=0, n_shards=1, max_pages=MAX_LP)
    kp, vp = x["kp"].clone(), x["vp"].clone()
    out = {}
    c = qkv_case(x, True)
    out["k1"] = timed(lambda: K.paged_qkv_write(
        c["q"], c["k"], c["v"], kp, vp, c["bt"], x["lengths"], x["fr"],
        x["wm"], meta, **c["args"]))
    # the plain composite it replaces (rms_norm and rope of q and k, then
    # write_kv, whose masked indexing syncs the host)
    out["k1_plain"] = timed(lambda: ref.qkv_write(
        c["q"], c["k"], c["v"], kp, vp, x["lengths"], c["bt"], x["fr"],
        x["wm"], **shard, **c["args"]))

    def replaced():
        # the parent's decode path: the plain norm and rotary, then old K1
        q, k = ref.qk_rotate(c["q"], c["k"], x["lengths"], **c["args"])
        K.paged_kv_write(k, c["v"], kp, vp, c["bt"], x["lengths"], x["fr"],
                         x["wm"], meta)
    out["k1_replaced"] = timed(replaced)
    out["k1_write_off"] = timed(lambda: K.qk_rotate(
        c["q"], c["k"], x["lengths"], **c["args"]))
    out["k1_old"] = timed(lambda: K.paged_kv_write(
        x["k_new"], x["v_new"], kp, vp, x["bt"], x["lengths"], x["fr"],
        x["wm"], meta))
    pools = [(x["kp"].clone(), x["vp"].clone()) for _ in range(8)]
    it = itertools.count()
    qg = x["q"].reshape(B, HKV, G, D)

    def k2():
        p = pools[next(it) % len(pools)]
        K.paged_gather_attend(qg, p[0], p[1], x["bt"], x["lengths"], meta)

    def k2_plain():
        p = pools[next(it) % len(pools)]
        ref.attend_shard(x["q"], p[0], p[1], x["lengths"], x["bt"], x["fl"],
                         head_start=0, group=G, window=None, **shard)
    out["k2"] = timed(k2)
    out["k2_plain"] = timed(k2_plain, iters=20)
    out["k2_blocks"] = B * HKV * build.n_splits(MAX_LP * PS)
    b1, ops1 = k1_qkv_work(x, c)
    b2, ops2 = k2_work(x, 1, 0, None)
    out["k1_bound_ms"] = max(b1 / HBM_BYTES_PER_S, ops1 / F32_FLOPS_PER_S) * 1e3
    out["k1_bound_by"] = ("bytes" if b1 / HBM_BYTES_PER_S
                          >= ops1 / F32_FLOPS_PER_S else "operations")
    out["k2_bound_ms"] = max(b2 / HBM_BYTES_PER_S, ops2 / F32_FLOPS_PER_S) * 1e3
    out["k2_bound_by"] = ("bytes" if b2 / HBM_BYTES_PER_S
                          >= ops2 / F32_FLOPS_PER_S else "operations")
    out["k1_bytes"], out["k1_ops"] = b1, ops1
    out["k1_rows_written"] = len(k1_writers(x, 1, 0, c["bt_np"])[0])
    out["k2_bytes"], out["k2_ops"] = b2, ops2
    return out


# -- phase 3 -------------------------------------------------------------------

def full_cfg(dtype: str, **kw):
    """qwen3-0.6b at full width in ``dtype``; pooled 16-slot pages unless
    ``kw`` says otherwise."""
    from repro_torch.configs import get_config
    base = dict(kv_layout="pooled", kv_page_slots=16, param_dtype=dtype,
                compute_dtype=dtype)
    return dataclasses.replace(get_config("qwen3-0.6b"), **{**base, **kw})


class PagedStepProbe:
    """Wraps the paged decode step (``ops.paged_decode_shard``).  In mode
    "check" each kernel step (K1 + K2) is also run by the composed oracle
    on copies of the pages it was given, and held to it on these real
    inputs: the pages K1 wrote as ``qkv_close`` holds them (bit for bit
    without qk_norm); with M the largest |m| of the call (at least 1), m
    within M_ATOL + K2_RTOL M, acc within (K2_ATOL + K2_RTOL times the
    largest |acc| of its (sequence, head) row) M and l within (K2_ATOL +
    K2_RTOL |l|) M.  An f32 score carries an absolute rounding error of a
    few ulps of its terms' scale, which M measures (a score can cancel far
    below it), exp() turns that into a relative error of p, and a sum of
    real V rows can cancel far below its terms' scale too; the random-
    weight archs' scores reach the hundreds to the thousands, phase
    kernels' random q and k keep M near 1.  ``err`` keeps the largest
    errors.  In mode "reordered" each composed step is the oracle summed in
    another order: its scores' dot products over the head dim in reverse
    order, its positions as two emulated shards (frame f on shard f % 2 at
    row f // 2) merged by ``merge_shard_partials``.  Otherwise the step is
    untouched."""

    def __init__(self):
        self.mode, self.steps = None, 0
        self.err = {"k1": 0.0, "k1_bits_differ": {}, "k2_acc": 0.0,
                    "k2_l": 0.0, "k2_m": 0.0}

    def __enter__(self):
        from repro_torch.kernels.paged_decode import ops
        self.ops, self.step = ops, ops.paged_decode_shard
        ops.paged_decode_shard = self._step
        return self

    def __exit__(self, *exc):
        self.ops.paged_decode_shard = self.step

    def _step(self, *args, impl, **kw):
        if self.mode == "check" and impl == "fused":
            return self._check(*args, impl=impl, **kw)
        if self.mode == "reordered" and impl == "composed":
            return self._reordered(*args, impl=impl, **kw)
        return self.step(*args, impl=impl, **kw)

    def _check(self, q, k_new, v_new, k_pages, v_pages, *rest, **kw):
        kp, vp = k_pages.clone(), v_pages.clone()
        got = self.step(q, k_new, v_new, k_pages, v_pages, *rest, **kw)
        want = self.step(q, k_new, v_new, kp, vp, *rest,
                         **{**kw, "impl": "composed"})
        exact = kw.get("q_norm") is None
        what = f"on real inputs, step {self.steps}"
        qkv_close(got[3], want[3], exact, self.err, f"K pages {what}")
        qkv_close(got[4], want[4], True, self.err, f"V pages {what}")
        m = want[1]
        cond = max(1.0, m.masked_fill(m < -1e29, 0.0).abs().max().item())
        acc_scale = want[0].abs().amax(-1, keepdim=True)
        for name, g, w, tol in (
                ("acc", got[0], want[0],
                 (K2_ATOL + K2_RTOL * acc_scale) * cond),
                ("m", got[1], m, M_ATOL + K2_RTOL * cond),
                ("l", got[2], want[2],
                 (K2_ATOL + K2_RTOL * want[2].abs()) * cond)):
            d = (g - w).abs()
            self.err[f"k2_{name}"] = max(self.err[f"k2_{name}"],
                                         d.max().item())
            if not bool((d <= tol).all()):
                raise AssertionError(f"K2 {name} {what}: max |diff| "
                                     f"{d.max().item()}")
        self.steps += 1
        return got

    def _reordered(self, q, k_new, v_new, k_pages, v_pages, lengths, bt,
                   fl, fr, wm, *, sid, n_shards, head_start, group, window,
                   max_pages, use_vm, impl, **epilogue):
        import torch
        from repro_torch.kernels.paged_decode import ref
        from repro_torch.parallel.paged_attention import merge_shard_partials
        bt_, fl_ = (bt, fl) if use_vm else (None, None)
        q = ref.qkv_write(q, k_new, v_new, k_pages, v_pages, lengths, bt_, fr,
                          wm, sid=sid, n_shards=n_shards, max_pages=max_pages,
                          **epilogue)
        rev = torch.arange(q.shape[-1] - 1, -1, -1, device=q.device)
        q, k_rev = q[..., rev], k_pages[..., rev]
        parts = [ref.attend_shard(q, k_rev[s::2], v_pages[s::2], lengths,
                                  bt_, fl_, sid=s, n_shards=2,
                                  head_start=head_start, group=group,
                                  window=window, max_pages=max_pages)
                 for s in (0, 1)]
        accs, ms, ls = (torch.stack([p[i] for p in parts]) for i in range(3))
        out = merge_shard_partials(accs, ms, ls)
        return out, ms.amax(0), torch.ones_like(ls[0]), k_pages, v_pages


class PinnedRouting:
    """Teacher forcing of the MoE blocks' expert choices: while ``mode`` is
    "record" each ``moe._route`` call keeps its top-k ids; while it is
    "replay" each call takes the recorded ids of the same call in order
    (its weights renormalised from its own probabilities at those ids) and
    counts the tokens whose own choice differed (``flips``).  Otherwise the
    routing is untouched."""

    def __init__(self):
        self.mode, self.ids, self.at = None, [], 0
        self.flips = self.routed = 0

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.route = moe, moe._route
        moe._route = self._route
        return self

    def __exit__(self, *exc):
        self.moe._route = self.route

    def start(self, mode: str | None) -> None:
        self.mode, self.at = mode, 0
        if mode == "record":
            self.ids = []

    def _route(self, cfg, p, xt):
        probs, weights, idx = self.route(cfg, p, xt)
        if self.mode == "record":
            self.ids.append(idx)
        elif self.mode == "replay":
            pinned = self.ids[self.at]
            self.at += 1
            own = idx.sort(-1).values != pinned.sort(-1).values
            self.flips += int(own.any(-1).sum().item())
            self.routed += idx.shape[0]
            weights = probs.gather(1, pinned)
            weights, idx = weights / weights.sum(-1, keepdim=True), pinned
        return probs, weights, idx


def phase_teacher(dev, dtype: str, steps: int = 64, model=None,
                  lockstep: bool = False):
    """Teacher-forced decode with the kernels and with the composed oracle
    on the same weights, tokens and tables; sequences start staggered (4
    steps apart) and two share a read-only page-0 frame.  The model is
    qwen3-0.6b in ``dtype``, or ``model`` (pooled, 16-slot pages) where
    given.  The two decodes run free, each on its own cache; that
    comparison is gated unless ``lockstep`` is set.

    With ``lockstep`` (phase archs) the kernel decode's K1 and K2 steps are
    each held to the composed oracle on their real inputs
    (PagedStepProbe), and two more decodes run each step from the kernel
    decode's cache as it stood before the step and with its MoE expert
    choices (PinnedRouting): the composed oracle, and the same oracle
    summed in another order (PagedStepProbe's "reordered").  The gated
    comparison is then one step on the same history and routing, kernels
    against the oracle, within the larger of LOGIT_RTOL and ORDER_FACTOR
    times the oracle's own disagreement across the two orders; the free
    one is reported beside it.  (A routing choice is a discontinuous function of
    its input; the reference's initialiser (std of the period count's
    fan-in) gives scores in the hundreds to thousands, where two f32
    summation orders of q.k part by 1e-3 to 1e-2 of p; and a deep random-
    weight model amplifies a bf16 rounding that flips into logit changes
    of several percent.  So the free-running logits of the MoE archs, and
    the logits of 40-layer granite and of the 8-layer MoE archs even in
    one step, part by more than LOGIT_RTOL whatever kernel runs.)"""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.models.model import Model
    from repro_torch.parallel.paged_attention import paged_entries
    if model is None:
        model = Model(full_cfg(dtype), device=dev, seed=0)
    cfg = model.cfg
    rng = np.random.default_rng(3)
    max_lp = -(-steps // cfg.kv_page_slots)
    n_frames = B * max_lp + 1
    bt = np.full((B, max_lp), -1, np.int32)
    fl = np.zeros((n_frames,), np.int32)
    fr = np.zeros((n_frames,), bool)
    perm = list(rng.permutation(B * max_lp))
    shared = B * max_lp
    fr[shared] = True
    for s in range(B):
        for lp in range(max_lp):
            f = shared if (s >= 6 and lp == 0) else int(perm.pop())
            bt[s, lp], fl[f] = f, lp
    caches = {}
    for impl in ("auto", "composed") + (
            ("lockstep", "reordered") if lockstep else ()):
        c = T.init_cache(dataclasses.replace(cfg, kv_pool_pages=n_frames),
                         B, steps, dev)
        g = torch.Generator(device=dev).manual_seed(1)
        for _, entry in paged_entries(c):     # the shared frame's content
            for name in ("k_pages", "v_pages"):
                entry[name][:, shared] = torch.randn(
                    entry[name][:, shared].shape, generator=g, device=dev
                ).to(entry[name].dtype)
        c["vm"] = {"block_table": torch.tensor(bt, device=dev),
                   "frame_lpage": torch.tensor(fl, device=dev),
                   "frame_ro": torch.tensor(fr, device=dev)}
        caches[impl] = c
    start = np.arange(B) * 4
    toks = rng.integers(0, cfg.vocab_size, (steps + int(start[-1]), B))
    diff = {impl: 0.0 for impl in caches if impl != "auto"}
    agree = dict.fromkeys(diff, 0)
    max_ref = early_diff = 0.0
    total = 0
    pin, probe = PinnedRouting(), PagedStepProbe()
    with torch.no_grad(), pin, probe:
        for k in range(steps + int(start[-1])):
            lengths = np.clip(k - start + 1, 0, steps).astype(np.int32)
            wm = (k >= start) & (k - start < steps)
            if not wm.any():
                continue
            tok = torch.tensor(toks[k, :, None].astype(np.int32), device=dev)
            for copy in ("lockstep", "reordered")[:2 * lockstep]:
                # the kernel decode's history, before the step
                for key, entry in caches["auto"].items():
                    if key.startswith("b"):
                        for name, t in entry.items():
                            caches[copy][key][name].copy_(t)
            outs = {}
            for impl, c in caches.items():
                pin.start({"auto": "record", "composed": None}.get(
                    impl, "replay"))
                probe.mode = {"auto": "check" if lockstep else None,
                              "reordered": "reordered"}.get(impl)
                outs[impl], _ = T.decode_step(
                    dataclasses.replace(
                        cfg, paged_kernel="auto" if impl == "auto"
                        else "composed"), model.params,
                    tok, c, torch.tensor(lengths, device=dev),
                    torch.tensor(wm, device=dev), periods=model.periods())
            pin.start(None)
            probe.mode = None
            live = torch.tensor(wm, device=dev)
            for impl in diff:
                # the kernels against each oracle run, and the reordered
                # oracle against the oracle; the padded vocab columns hold
                # -1e30 on every path
                base = outs["lockstep"] if impl == "reordered" else outs["auto"]
                a = base[live, :cfg.vocab_size]
                r = outs[impl][live, :cfg.vocab_size]
                diff[impl] = max(diff[impl], (a - r).abs().max().item())
                agree[impl] += int((a.argmax(-1) == r.argmax(-1)).sum().item())
            max_ref = max(max_ref, outs["composed"][live, :cfg.vocab_size]
                          .abs().max().item())
            if k < 8:                  # before cache differences build up
                early_diff = diff["composed"]
            total += int(live.sum().item())
    rel = {impl: d / max_ref for impl, d in diff.items()}
    gated = "lockstep" if lockstep else "composed"
    lim = LOGIT_RTOL[dtype]
    if lockstep:
        lim = max(lim, ORDER_FACTOR * rel["reordered"])
    if not np.isfinite(rel[gated]) or rel[gated] > lim:
        raise AssertionError(f"teacher-forced logits ({dtype}, {gated}): "
                             f"kernels vs composed max |diff| {diff[gated]} "
                             f"= {rel[gated]} of max |logit| {max_ref} > "
                             f"{lim}")
    del model, caches
    torch.cuda.empty_cache()
    out = {"dtype": dtype, "max_abs_diff": diff["composed"],
           "max_abs_logit": max_ref, "rel": rel["composed"],
           "rtol": LOGIT_RTOL[dtype],
           "rel_first_8_steps": early_diff / max_ref,
           "argmax_agree": f"{agree['composed']}/{total}"}
    if lockstep:
        out.update(gated="lockstep", limit=lim,
                   lockstep_max_abs_diff=diff["lockstep"],
                   lockstep_rel=rel["lockstep"],
                   lockstep_argmax_agree=f"{agree['lockstep']}/{total}",
                   reordered_rel=rel["reordered"],
                   routing_flips=f"{pin.flips}/{pin.routed}",
                   real_input_steps=probe.steps, real_input_err=probe.err)
    return out


# -- phases 4 and 5 --------------------------------------------------------------

def serve(dev, dtype: str, **cfg_kw):
    """Replay the trace through the full-width qwen3-0.6b engine (pooled
    layout unless ``cfg_kw`` says otherwise); returns (per-uid outputs,
    shutdown stats, seconds)."""
    cfg = full_cfg(dtype, **{"kv_pool_pages": SERVE_POOL, **cfg_kw})
    return serve_model(dev, cfg, SERVE_ENGINE, SERVE_TRACE)


def serve_model(dev, cfg, engine: dict, trace: dict, model=None):
    """Replay ``trace`` through ``cfg``'s engine + scheduler (random weights
    from seed 0, or ``model``'s under ``cfg``); returns (per-uid outputs,
    shutdown stats, seconds)."""
    import torch
    from repro_torch.models.model import Model
    from repro_torch.serve import (EngineConfig, Scheduler, ServeEngine,
                                   TraceConfig, generate, replay)
    model = (Model(cfg, device=dev, seed=0) if model is None
             else model.with_config(cfg))
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with ServeEngine(model, EngineConfig(**engine)) as eng:
        done = replay(generate(TraceConfig(**trace)), Scheduler(eng))
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    stats = eng.shutdown()
    if len(done) != trace["n_requests"] or not all(r.done for r in done):
        raise AssertionError(f"{len(done)} of {trace['n_requests']} "
                             "requests completed")
    if stats["leaked_frames"]:
        raise AssertionError(f"leaked frames: {stats['leaked_frames']}")
    outputs = {r.uid: tuple(r.output) for r in done}
    del model, eng
    torch.cuda.empty_cache()
    return outputs, stats, dt


def attn_layers(cfg) -> int:
    """Attention layers of ``cfg``: a decode step launches K1 and K2 (or K4)
    once in each."""
    return cfg.n_periods * sum(cfg.layer_kind(i) == "attn"
                               for i in range(cfg.layer_period))


def phase_serve(dev):
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_decode import kernel as K
    K.reset_launch_counts()
    outputs, stats, dt = serve(dev, "bfloat16")
    launches = dict(K.LAUNCHES)
    n_attn = attn_layers(get_config("qwen3-0.6b"))
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} was never launched on the main path")
        if n != n_attn * stats["decode_steps"]:
            raise AssertionError(f"{name}: {n} launches for "
                                 f"{stats['decode_steps']} decode steps")
    if stats["swapped"] < 1 or stats["shared_prompt_tokens"] <= 0:
        raise AssertionError(f"swapped={stats['swapped']} shared_prompt_tokens="
                             f"{stats['shared_prompt_tokens']}")
    new_tokens = sum(len(o) for o in outputs.values())
    cfg = full_cfg("bfloat16")
    weight_bytes = cfg.param_count() * 2
    return launches, {
        "completed": len(outputs), "new_tokens": new_tokens,
        "decode_steps": stats["decode_steps"],
        "dispatches": stats["dispatches"], "swapped": stats["swapped"],
        "shared_prompt_tokens": stats["shared_prompt_tokens"],
        "launches": launches, "wall_s": dt,
        "tokens_per_s": new_tokens / dt,
        "decode_step_ms": dt / stats["decode_steps"] * 1e3,
        "weight_bytes": weight_bytes,
        "weight_read_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
        "p99_ttft_steps": stats["telemetry"]["ttft_steps"]["p99"],
        "mean_itl_steps": stats["telemetry"]["itl_steps"]["mean"]}


def phase_tokens(dev):
    kern, st_k, dt_k = serve(dev, "float32", paged_kernel="auto")
    comp, st_c, dt_c = serve(dev, "float32", paged_kernel="composed")
    if kern != comp:
        bad = sorted(u for u in kern if kern[u] != comp.get(u))
        raise AssertionError(f"f32 served tokens differ, kernels vs composed, "
                             f"for uids {bad}")
    if st_k["telemetry"] != st_c["telemetry"]:
        raise AssertionError("f32 telemetry differs, kernels vs composed")
    return {"requests": len(kern),
            "new_tokens": sum(len(o) for o in kern.values()),
            "kernels_s": dt_k, "composed_s": dt_c}


#: each wrapper's CUDA kernel, by the symbol the profiler reports
KERNEL_SYMBOLS = {"paged_kv_write": ("qkv_write_kernel",),
                  "paged_gather_attend": ("gather_attend_kernel",),
                  "flash_attention": ("fa_kernel", "fa_tc_kernel"),
                  "flash_decode": ("flash_decode_kernel",),
                  "ssd": ("ssd_kernel", "ssd_tc_kernel", "ssd_cb_kernel")}


def phase_profile(dev, layout: str, steps: int = 10, cfg=None, model=None):
    """Where a decode step's time goes: full-width bf16 decode of 8
    sequences at ~256 tokens (pooled: over scrambled tables, K1/K2; batch:
    attn_impl "pallas", K4; or ``cfg``'s model, or ``model`` itself), each
    step synced to the host as the engine's stepwise path does.  Wall time
    per step (no profiler), then device time per step by kernel from
    torch.profiler."""
    import torch
    from repro_torch.models.model import Model
    from repro_torch.serve.fused_decode import sampled_decode_step
    if model is not None:
        cfg = model.cfg
    if cfg is None:
        cfg = (full_cfg("bfloat16") if layout == "pooled" else
               full_cfg("bfloat16", kv_layout="batch", attn_impl="pallas"))
    if model is None:
        model = Model(cfg, device=dev, seed=0)
    cache = model.init_cache(B, MAX_LP * PS)
    rng = np.random.default_rng(5)
    start = 256
    if layout == "pooled":
        bt, fl, fr = mk_vm(rng, B, MAX_LP, PS, [MAX_LP * PS] * B, False)
        cache["vm"] = {"block_table": torch.tensor(bt, device=dev),
                       "frame_lpage": torch.tensor(fl, device=dev),
                       "frame_ro": torch.tensor(fr, device=dev)}
    wm = torch.ones(B, dtype=torch.bool, device=dev)
    pos = itertools.count(start)

    def step():
        n = next(pos)
        lengths = torch.full((B,), n, dtype=torch.int32, device=dev)
        tok = torch.tensor(rng.integers(0, cfg.vocab_size, (B, 1)),
                           dtype=torch.int32, device=dev)
        sampled, _, _ = sampled_decode_step(model, tok, cache, lengths, wm)
        return sampled.cpu()

    # one step with its inputs made beforehand and no read-back, for the
    # queued-event clock: nothing in it waits for the device
    tok_q = torch.tensor(rng.integers(0, cfg.vocab_size, (B, 1)),
                         dtype=torch.int32, device=dev)
    len_q = torch.full((B,), start, dtype=torch.int32, device=dev)

    def step_queued():
        sampled_decode_step(model, tok_q, cache, len_q, wm)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    dev_ms, by_name = device_profile(step, iters=steps, warmup=0)
    # one step at a time behind a ~0.2 s sleep: the card's launch queue
    # holds about a thousand launches (launch_queue_ms) and a pooled step
    # is 999; a longer step (batch: 1307) makes the host wait for the
    # card, and reads None
    singles = [queued_ms(step_queued, iters=1, warmup=1,
                         sleep_cycles=400_000_000) for _ in range(steps)]
    events_ms = None if None in singles else float(np.median(singles))
    del model, cache
    torch.cuda.empty_cache()
    out = {"model": cfg.name, "layout": layout, "wall_ms_per_step": wall_ms,
           "device_ms_per_step": dev_ms,
           "events_device_ms_per_step": events_ms,
           "events_busy_share": (None if events_ms is None
                                 else events_ms / wall_ms),
           "launch_queue_ms": launch_queue_ms(dev)}
    if dev_ms is None:
        return out
    ops = by_name.pop("device_ops_per_call")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    out.update(busy_share=dev_ms / wall_ms, device_ops_per_step=ops,
               profiler_over_events=(None if events_ms is None
                                     else dev_ms / events_ms),
               kernel_ms_per_step={
                   name: sum(v for k, v in by_name.items()
                             if any(sym in k for sym in syms))
                   for name, syms in KERNEL_SYMBOLS.items()},
               top_kernels_ms_per_step=[[k[:80], v] for k, v in top])
    return out


# -- phase 6 -------------------------------------------------------------------

def close(got, want, dtype: str, what: str, err: dict, key: str):
    """``got`` within the phase-6 tolerance of ``want``; folds the max
    error into ``err[key]``."""
    dlt = (got.float() - want.float()).abs()
    e = dlt.max().item() if dlt.numel() else 0.0
    err[key] = max(err[key], e)
    tol = FLASH_ATOL + FLASH_RTOL[dtype] * want.float().abs()
    if not bool((dlt <= tol).all()):
        raise AssertionError(f"{key} differs from plain by {e}: {what}")


def fa_case(seed, dtype, dev, b=8, hq=16, hkv=8, sq=512, skv=512, d=128):
    import torch
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.tensor(rng.normal(size=shape).astype(np.float32),
                            device=dev).to(dtype)
    return t(b, hq, sq, d), t(b, hkv, skv, d), t(b, hkv, skv, d)


def check_k3(q, k, v, causal, window, err, variant=None):
    """K3 against ref.mha on one input set, through the variant its wrapper
    picks (which must be ``variant_for``'s) or the one named; returns the
    variant that ran."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as K3
    from repro_torch.kernels.flash_attention import ref
    tc = K3.LAUNCHES["flash_attention_tc"]
    out = K3.flash_attention(q, k, v, causal=causal, window=window,
                             variant=variant)
    ran = ("tensor_core" if K3.LAUNCHES["flash_attention_tc"] > tc
           else "cuda_core")
    if ran != (variant or K3.variant_for(q.dtype, q.shape[-1])):
        raise AssertionError(f"K3 ran {ran} for {q.dtype} D={q.shape[-1]}, "
                             f"asked {variant}")
    want = ref.mha(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    dtype = str(q.dtype).split(".")[1]
    close(out, want, dtype, f"{dtype} {ran} q {tuple(q.shape)} k "
          f"{tuple(k.shape)} causal={causal} window={window}", err, "k3")
    return ran


def fd_case(seed, dtype, dev, g=G, d=D, s=512, b=B, hkv=HKV, lengths=None):
    """K4 inputs: q [B, Hkv*G, D], k/v [B, Hkv, S, D], ragged lengths with
    an empty row and a one-token row (or ``lengths``, whose row 1 is 0)."""
    import torch
    rng = np.random.default_rng(seed)
    if lengths is None:
        lengths = rng.integers(2, s + 1, b).astype(np.int32)
        lengths[1], lengths[2] = 0, 1
    lengths = np.asarray(lengths, np.int32)

    def t(*shape):
        return torch.tensor(rng.normal(size=shape).astype(np.float32),
                            device=dev).to(dtype)
    return (t(b, hkv * g, d), t(b, hkv, s, d), t(b, hkv, s, d),
            torch.tensor(lengths, device=dev), lengths)


def check_k4(x, window, err):
    """K4 (through flash_ops with the kernel) against its plain version, the
    non-kernel branch of flash_ops.decode_attention_partial: out, m and l;
    row 1 is empty and must be exactly (0, -1e30, 0)."""
    import torch
    from repro_torch.kernels.paged_decode import flash_ops
    q, k, v, lengths, _ = x
    kern = flash_ops.decode_attention_partial(q, k, v, lengths, window=window,
                                              use_kernel=True)
    plain = flash_ops.decode_attention_partial(q, k, v, lengths,
                                               window=window, use_kernel=False)
    torch.cuda.synchronize()
    dtype = str(q.dtype).split(".")[1]
    what = (f"{dtype} q {tuple(q.shape)} k {tuple(k.shape)} "
            f"window={window}")
    close(kern[0], plain[0], dtype, what, err, "k4")
    close(kern[1], plain[1], "float32", "m " + what, err, "k4")
    close(kern[2], plain[2], "float32", "l " + what, err, "k4")
    if not (bool((kern[0][1] == 0).all()) and bool((kern[1][1] == -1e30).all())
            and bool((kern[2][1] == 0).all())):
        raise AssertionError(f"K4: empty row is not (0, -1e30, 0): {what}")


#: K4 lengths at its 64-position split edges (row 1 empty), for S = 512 and
#: S = 200; window 40 straddles an edge in rows 3 and 7 (S = 512), 4 and 5
#: (S = 200)
FD_EDGE_LENGTHS = {512: [63, 0, 64, 65, 512, 1, 128, 200],
                   200: [200, 0, 63, 64, 65, 129, 150, 1]}


def same_k4_bits(x, window):
    """Two K4 launches on the same inputs give the same bits."""
    import torch
    from repro_torch.kernels.paged_decode import flash as K4
    q, k, v, lengths, _ = x
    qg = q.reshape(q.shape[0], k.shape[1], -1, q.shape[-1])
    a = K4.flash_decode(qg, k, v, lengths, window=window)
    c = K4.flash_decode(qg, k, v, lengths, window=window)
    torch.cuda.synchronize()
    return all(torch.equal(s.view(torch.int16 if s.element_size() == 2
                                  else torch.int32),
                           t.view(torch.int16 if t.element_size() == 2
                                  else torch.int32))
               for s, t in zip(a, c))


def phase_flash(dev):
    import torch
    from repro_torch.kernels.flash_attention import kernel as K3
    err = {"k3": 0.0, "k4": 0.0}
    ran = {"tensor_core": 0, "cuda_core": 0}
    for dt in (torch.float32, torch.bfloat16):
        def k3(*a, **kw):
            ran[check_k3(*a, err, **kw)] += 1
        q, k, v = fa_case(31, dt, dev)                 # the prefill shapes
        for causal, window in ((True, None), (True, 64), (False, None)):
            k3(q, k, v, causal, window)
        k3(q[:, :, -100:].contiguous(), k, v, True, None)  # tail queries
        k3(q[:, :, -100:].contiguous(), k, v, True, 64)
        for hq, hkv, d in ((8, 8, 128), (16, 4, 128), (16, 8, 64)):
            k3(*fa_case(37, dt, dev, b=2, hq=hq, hkv=hkv, d=d), True, None)
        for causal in (True, False):
            k3(*fa_case(41, dt, dev, b=2, sq=200, skv=200), causal, 64)
        q64, k64, v64 = fa_case(39, dt, dev, d=64)     # D 64 at full size
        for window in (None, 64):
            k3(q64, k64, v64, True, window)
        if dt == torch.bfloat16:
            # the CUDA-core variant, forced, at the prefill shape
            for causal, window in ((True, None), (True, 64)):
                k3(q, k, v, causal, window, variant="cuda_core")
            # a head dim the tensor-core tile does not take: the CUDA cores
            # by choice, and a forced tensor-core launch raises
            x96 = fa_case(45, dt, dev, b=2, d=96)
            if K3.variant_for(dt, 96) != "cuda_core":
                raise AssertionError("K3 picks the tensor cores for D = 96")
            k3(*x96, True, None)
            try:
                K3.flash_attention(*x96, variant="tensor_core")
            except ValueError:
                pass
            else:
                raise AssertionError("K3's tensor-core variant took D = 96")
        x = fd_case(43, dt, dev)                       # the serving shapes
        for window in (None, 64):
            check_k4(x, window, err)
        # head dims 100 and 90: rows that 16-byte units do not divide (8-
        # and 4-byte units in bf16, 16 and 8 in f32)
        for g, d, s in ((1, 128, 512), (4, 128, 512), (2, 64, 512),
                        (2, 128, 200), (2, 100, 200), (2, 90, 130)):
            for window in (None, 64):
                check_k4(fd_case(47, dt, dev, g=g, d=d, s=s), window, err)
        other = torch.bfloat16 if dt == torch.float32 else torch.float32
        check_k4((x[0].to(other), *x[1:]), None, err)  # q and kv dtypes differ
        for s, lengths in FD_EDGE_LENGTHS.items():     # K4's split edges
            xe = fd_case(49, dt, dev, s=s, lengths=lengths)
            for window in (None, 40):
                check_k4(xe, window, err)
        for window in (None, 64):
            if not same_k4_bits(x, window):
                raise AssertionError(f"K4: two launches differ ({dt}, "
                                     f"window {window})")
    return err, {"k3_cases_by_variant": ran, **time_flash(dev)}


def p_rounding_fail_share(q, k, v, want):
    """Why K3 splits p before p.v: the share of bf16 outputs outside the
    phase-6 tolerance of ``want`` (ref.mha, causal) when the probabilities
    (taken from the final row max, as ref.mha does) are rounded to bf16 or
    to fp16 before p.v, or split into bf16 hi + lo; p.v and the division
    by l in f32, the output rounded to bf16 as ref.mha rounds it."""
    import torch
    from repro_torch.kernels.flash_attention import ref as fa_ref
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, sq, d).float()
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * d ** -0.5
    mask = fa_ref.attention_mask(sq, skv, causal=True, window=None,
                                 device=q.device)
    logits = torch.where(mask, logits, fa_ref.NEG_INF)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    del logits
    hi = p.bfloat16().float()
    share = {}
    for name, pr in (("bf16", hi), ("fp16", p.half().float()),
                     ("split_bf16", hi + (p - hi).bfloat16().float())):
        o = torch.einsum("bhgqk,bhkd->bhgqd", pr, v.float()) / l
        o = o.reshape(b, hq, sq, d).bfloat16().float()
        tol = FLASH_ATOL + FLASH_RTOL["bfloat16"] * want.abs()
        share[name] = ((o - want).abs() > tol).float().mean().item()
    return share


def time_flash(dev):
    """Kernel, plain and library times at the main paths' shapes in bf16:
    K3 causal at B=8, Hq=16, Hkv=8, S=512, D=128 (the prefill's), K4 at
    B=8, Hkv=8, G=2, S=512, D=128 with the ragged lengths of phase 6 (the
    batch serving path's).  Each cycles over copies of its inputs larger
    than the 50 MB L2 together, as every layer finds its K/V cold."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as K3
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.paged_decode import flash as K4
    from repro_torch.kernels.paged_decode import flash_ops
    out = {}
    fa = [fa_case(53 + i, torch.bfloat16, dev) for i in range(4)]
    it = itertools.count()

    def pick(xs):
        return xs[next(it) % len(xs)]
    out["k3"] = timed(lambda: K3.flash_attention(*pick(fa), causal=True))
    out["k3_cuda_core"] = timed(lambda: K3.flash_attention(
        *pick(fa), causal=True, variant="cuda_core"))
    out["k3_plain"] = timed(lambda: fa_ref.mha(*pick(fa), causal=True),
                            iters=20)
    out["k3_library"] = timed(lambda: F.scaled_dot_product_attention(
        *pick(fa), is_causal=True, enable_gqa=True))
    q, k, v = fa[0]
    # information, no gate: K3's and SDPA's largest error against ref.mha
    want = fa_ref.mha(q, k, v, causal=True).float()
    for key, got in (("k3", K3.flash_attention(q, k, v, causal=True)),
                     ("sdpa", F.scaled_dot_product_attention(
                         q, k, v, is_causal=True, enable_gqa=True))):
        out[f"{key}_max_abs_err_vs_ref"] = (got.float() - want).abs().max(
        ).item()
    out["k3_p_rounding_fail_share"] = p_rounding_fail_share(q, k, v, want)
    del want
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    pairs = int(np.tril(np.ones((sq, skv), bool), skv - sq).sum()) * b * hq
    k3_ops = 4 * d * pairs
    k3_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    fd = [fd_case(59 + i, torch.bfloat16, dev) for i in range(8)]
    lengths_np = fd[0][4]
    qg = [(x[0].reshape(B, HKV, G, D), x[1], x[2], x[3]) for x in fd]
    out["k4"] = timed(lambda: K4.flash_decode(*pick(qg)))
    out["k4_plain"] = timed(lambda: flash_ops.decode_attention_partial(
        *pick(fd)[:4], use_kernel=False), iters=20)
    pos = torch.arange(fd[0][1].shape[2], device=dev)
    masks = [(pos[None, :] < x[3][:, None].long())[:, None, None, :]
             for x in fd]
    lib = [(x[0][:, :, None], x[1], x[2], m) for x, m in zip(fd, masks)]

    def library():
        q4, k4, v4, mask = pick(lib)
        F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                       enable_gqa=True)
    out["k4_library"] = timed(library)
    out["k4_blocks"] = B * HKV * K4.n_splits(fd[0][1].shape[2])
    es = fd[0][1].element_size()
    attended = int(np.minimum(lengths_np, fd[0][1].shape[2]).sum())
    k4_bytes = (2 * attended * HKV * D * es + 2 * B * HKV * G * D * es
                + 4 * B + 2 * B * HKV * G * 4)
    k4_ops = 4 * G * D * HKV * attended
    for name, nbytes, ops, rate in (("k3", k3_bytes, k3_ops, BF16_FLOPS_PER_S),
                                    ("k4", k4_bytes, k4_ops, F32_FLOPS_PER_S)):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
        out[f"{name}_bound_ms"] = max(t_bytes, t_ops) * 1e3
        out[f"{name}_bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        out[f"{name}_bytes"], out[f"{name}_ops"] = nbytes, ops
    return out


# -- phase 7 -------------------------------------------------------------------

def phase_prefill(dev, dtype: str):
    """Full-width prefill of 8 prompts of 511 tokens with K3 (attn_impl
    "pallas") and with the plain oracle ("ref") on the same weights and
    tokens: logits and K/V cache within LOGIT_RTOL of their largest
    magnitude (f32 carries correctness; bf16 is a smoke check, as in phase
    3), and the device time of a prefill by torch.profiler beside its wall
    time.  Returns (K3 launches of the timed kernel prefill, results)."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as K3
    from repro_torch.kernels.paged_decode import flash as K4
    from repro_torch.models import transformer as T
    from repro_torch.models.model import Model
    cfg = full_cfg(dtype, kv_layout="batch", attn_impl="pallas")
    model = Model(cfg, device=dev, seed=0)
    rng = np.random.default_rng(7)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size,
                                     (PREFILL_B, PREFILL_S)), device=dev)
    model.prefill({"tokens": toks[:, :16]}, PREFILL_MAX_LEN)   # warm up
    torch.cuda.synchronize()
    K3.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = model.prefill({"tokens": toks}, PREFILL_MAX_LEN)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = K3.LAUNCHES["flash_attention"]
    tc = K3.LAUNCHES["flash_attention_tc"]
    if launches != cfg.n_layers:
        raise AssertionError(f"flash_attention: {launches} launches in one "
                             f"prefill of {cfg.n_layers} layers")
    # bf16 goes to the tensor cores (head dim 128), f32 to the CUDA cores
    if tc != (cfg.n_layers if dtype == "bfloat16" else 0):
        raise AssertionError(f"flash_attention: {tc} tensor-core launches in "
                             f"one {dtype} prefill of {cfg.n_layers} layers")
    # where the prefill's time goes: wall and device ms per prefill in a
    # steady state, K3's share of the device time
    t0 = time.perf_counter()
    for _ in range(3):
        model.prefill({"tokens": toks}, PREFILL_MAX_LEN)
    torch.cuda.synchronize()
    steady_ms = (time.perf_counter() - t0) / 3 * 1e3
    dev_ms, by_name = device_profile(
        lambda: model.prefill({"tokens": toks}, PREFILL_MAX_LEN), iters=3,
        warmup=0)
    t0 = time.perf_counter()
    ref_logits, ref_cache = T.prefill(
        dataclasses.replace(cfg, attn_impl="ref"), model.params,
        {"tokens": toks}, PREFILL_MAX_LEN, periods=model.periods())
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    rel = {"logits": ((logits - ref_logits).abs().max()
                      / ref_logits.abs().max()).item()}
    for key, entry in ref_cache.items():
        for name, want in entry.items():
            got = cache[key][name]
            rel[f"{key}/{name}"] = ((got.float() - want.float()).abs().max()
                                    / want.float().abs().max()).item()
    for what, r in rel.items():
        if not np.isfinite(r) or r > LOGIT_RTOL[dtype]:
            raise AssertionError(f"prefill {what} ({dtype}): kernel vs plain "
                                 f"{r} of max |value| > {LOGIT_RTOL[dtype]}")
    res = {"dtype": dtype, "rel_logits": rel["logits"],
           "rel_kv_max": max(v for k, v in rel.items() if k != "logits"),
           "rtol": LOGIT_RTOL[dtype], "prefill_ms": wall_ms,
           "plain_prefill_ms": plain_ms,
           "prompt_tokens_per_s": PREFILL_B * PREFILL_S / wall_ms * 1e3,
           "flash_attention_launches": launches,
           "flash_attention_tc_launches": tc,
           "steady_prefill_ms": steady_ms,
           "device_ms_per_prefill": dev_ms,
           "busy_share": None if dev_ms is None else dev_ms / steady_ms,
           "k3_device_ms_per_prefill": sum(
               v for k, v in by_name.items()
               if any(sym in k for sym in KERNEL_SYMBOLS["flash_attention"]))}
    del cache, ref_cache
    if dtype == "float32":
        # prefill(S-1) + one batch-layout decode step (K4) == prefill(S)
        K4.reset_launch_counts()
        _, short = model.prefill({"tokens": toks[:, :-1]}, PREFILL_MAX_LEN)
        lengths = torch.full((PREFILL_B,), PREFILL_S, dtype=torch.int32,
                             device=dev)
        dec, _ = model.decode_step(toks[:, -1:].to(torch.int32), short,
                                   lengths)
        r = ((dec - logits).abs().max() / logits.abs().max()).item()
        if not np.isfinite(r) or r > LOGIT_RTOL[dtype] \
                or K4.LAUNCHES["flash_decode"] != cfg.n_layers:
            raise AssertionError(f"prefill + decode vs prefill: rel {r}, "
                                 f"{K4.LAUNCHES['flash_decode']} K4 launches")
        res["rel_prefill_plus_decode"] = r
        del short
    del model
    torch.cuda.empty_cache()
    return launches, res


# -- phase 8 -------------------------------------------------------------------

def phase_batch(dev):
    """The phase-4 trace on the batch KV layout: bf16 with the kernels (every
    decode step of every layer launches K1 with its page write off, for the
    q/k norm and rotary, and K4; K2 and K3 never run), then f32 with the
    kernels and with the plain path (attn_impl "ref"), whose per-uid tokens
    and telemetry must be identical."""
    from repro_torch.kernels.flash_attention import kernel as K3
    from repro_torch.kernels.paged_decode import flash as K4
    from repro_torch.kernels.paged_decode import kernel as K
    batch = dict(kv_layout="batch")
    for mod in (K, K3, K4):
        mod.reset_launch_counts()
    outputs, stats, dt = serve(dev, "bfloat16", attn_impl="pallas", **batch)
    launches = K4.LAUNCHES["flash_decode"]
    k1 = K.LAUNCHES["paged_kv_write"]
    others = {"paged_gather_attend": K.LAUNCHES["paged_gather_attend"],
              **K3.LAUNCHES}
    n_attn = attn_layers(full_cfg("bfloat16"))
    for name, n in (("flash_decode", launches), ("paged_kv_write", k1)):
        if n == 0 or n != n_attn * stats["decode_steps"]:
            raise AssertionError(f"{name}: {n} launches for "
                                 f"{stats['decode_steps']} decode steps")
    if any(others.values()):
        raise AssertionError(f"batch serving launched other kernels: {others}")
    kern, st_k, dt_k = serve(dev, "float32", attn_impl="pallas", **batch)
    plain, st_p, dt_p = serve(dev, "float32", attn_impl="ref", **batch)
    if kern != plain:
        bad = sorted(u for u in kern if kern[u] != plain.get(u))
        raise AssertionError(f"f32 batch-layout tokens differ, kernels vs "
                             f"plain, for uids {bad}")
    if st_k["telemetry"] != st_p["telemetry"]:
        raise AssertionError("f32 batch-layout telemetry differs")
    new_tokens = sum(len(o) for o in outputs.values())
    return launches, {
        "completed": len(outputs), "new_tokens": new_tokens,
        "decode_steps": stats["decode_steps"],
        "dispatches": stats["dispatches"], "flash_decode_launches": launches,
        "paged_kv_write_launches": k1,
        "wall_s": dt, "tokens_per_s": new_tokens / dt,
        "decode_step_ms": dt / stats["decode_steps"] * 1e3,
        "f32_tokens_identical": len(kern), "f32_kernels_s": dt_k,
        "f32_plain_s": dt_p}


# -- phase 9 -------------------------------------------------------------------

def ssd_case(seed, dtype, dev, bt, s, h, p, n, g):
    """K5 inputs in the reference tests' distributions: x, B, C in
    ``dtype``; dt [Bt, S, H], A, D [H] in f32."""
    import torch
    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.tensor(a.astype(np.float32), device=dev).to(dt)
    return (t(rng.normal(size=(bt, s, h, p)), dtype),
            t(rng.uniform(0.01, 0.2, size=(bt, s, h))),
            t(-rng.uniform(0.5, 2.0, size=(h,))),
            t(rng.normal(size=(bt, s, g, n)), dtype),
            t(rng.normal(size=(bt, s, g, n)), dtype),
            t(rng.normal(size=(h,))))


def check_k5(args, chunk, err, variant=None):
    """K5 against ref.ssd_chunked on one input set: y and the final state
    within SSD_TOL; folds the max errors into ``err``.  ``variant``: None
    lets the wrapper pick.  Returns the variant that ran."""
    import torch
    from repro_torch.kernels.mamba2_ssd import kernel as K5
    from repro_torch.kernels.mamba2_ssd import ref
    tc = K5.LAUNCHES["ssd_tc"]
    got = K5.ssd(*args, chunk=chunk, variant=variant)
    ran = "tensor_core" if K5.LAUNCHES["ssd_tc"] > tc else "cuda_core"
    want = ref.ssd_chunked(*args, chunk=chunk)
    torch.cuda.synchronize()
    dtype = str(args[0].dtype).split(".")[1]
    rtol_y, atol_y, tol_state = SSD_TOL[dtype]
    what = (f"{dtype} x {tuple(args[0].shape)} B {tuple(args[3].shape)} "
            f"chunk={chunk} ({ran})")
    for key, g, w, rtol, atol in (("k5", got[0], want[0], rtol_y, atol_y),
                                  ("k5_state", got[1], want[1], tol_state,
                                   tol_state)):
        dlt = (g.float() - w.float()).abs()
        e = dlt.max().item()
        err[key] = max(err[key], e)
        if not bool((dlt <= atol + rtol * w.float().abs()).all()):
            raise AssertionError(f"{key} differs from plain by {e}: {what}")
    return ran


def same_k5_bits(args, chunk) -> bool:
    """Two tensor-core launches on the same inputs give the same bits."""
    import torch
    from repro_torch.kernels.mamba2_ssd import kernel as K5
    a = K5.ssd(*args, chunk=chunk, variant="tensor_core")
    b = K5.ssd(*args, chunk=chunk, variant="tensor_core")
    return torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def phase_ssd(dev):
    """K5 against its plain version at the prefill's shape and at other
    lengths (a tail chunk), groups and chunks, f32 and bf16, each through
    the variant the wrapper picks; the CUDA-core variant forced at the
    prefill shape; the tensor-core variant refusing the shapes it does not
    take and giving the same bits twice."""
    import torch
    from repro_torch.kernels.mamba2_ssd import kernel as K5
    err = {"k5": 0.0, "k5_state": 0.0}
    ran = {"tensor_core": 0, "cuda_core": 0}

    def k5(*a, **kw):
        ran[check_k5(*a, err, **kw)] += 1
    main = {k: v for k, v in SSD_SHAPE.items() if k != "chunk"}
    chunk = SSD_SHAPE["chunk"]
    for dt in (torch.float32, torch.bfloat16):
        x = ssd_case(61, dt, dev, **main)
        k5(x, chunk)
        k5(x, chunk, variant="cuda_core")
        for s in (200, 511):
            k5(ssd_case(67, dt, dev, bt=2, s=s, h=48, p=64, n=128, g=2), 64)
        # the smoke config's widths and chunk, and a chunk that is no
        # multiple of the CUDA-core variant's 32-row tiles nor of the
        # tensor cores' 16 rows: in bf16 both go to the CUDA cores by
        # choice, and a forced tensor-core launch raises
        smoke = ssd_case(73, dt, dev, bt=2, s=37, h=4, p=32, n=16, g=1)
        c100 = ssd_case(79, dt, dev, bt=2, s=100, h=8, p=64, n=128, g=1)
        k5(smoke, 8)
        k5(c100, 100)
        # narrower widths that bf16 sends to the tensor cores' run-time
        # instance, each with a tail chunk: idle warps (P < 64, N < 128,
        # chunk < 128) and the swizzles of 2, 4, 6 and 12 16-byte chunks
        for seed, (p, n, ch, s, h, g) in enumerate(SSD_NARROW):
            k5(ssd_case(97 + seed, dt, dev, bt=2, s=s, h=h, p=p, n=n, g=g),
               ch)
        if dt != torch.bfloat16:
            continue
        for what, xr, ch in (("P 32, N 16, chunk 8", smoke, 8),
                             ("chunk 100", c100, 100)):
            if K5.variant_for(dt, xr[0].shape[3], xr[3].shape[3], ch) \
                    != "cuda_core":
                raise AssertionError(f"K5 picks the tensor cores for {what}")
            try:
                K5.ssd(*xr, chunk=ch, variant="tensor_core")
            except ValueError:
                pass
            else:
                raise AssertionError(f"K5's tensor-core variant took {what}")
        if not same_k5_bits(x, chunk):
            raise AssertionError("K5: two tensor-core launches differ")
    # the tensor cores ran bf16 at the prefill shape, at S 200 and 511 and
    # at the narrower widths
    if ran["tensor_core"] != 3 + len(SSD_NARROW):
        raise AssertionError(f"K5 cases by variant: {ran}")
    return err, {"k5_cases_by_variant": ran, **time_ssd(dev)}


def ssd_work(args, chunk):
    """(bytes, operations) the SSD scan must spend on these inputs: x, B,
    C, dt, A and D read once, y and the f32 final state written once;
    2 (N + P) operations per causal (query, key) pair inside a chunk (C.B
    and the weighted sum of x) and 4 N P per position (C . state and the
    state update)."""
    x, dt, A, B, C, D = args
    bt, s, h, p = x.shape
    n = B.shape[3]
    nbytes = ((2 * x.numel() + B.numel() + C.numel()) * x.element_size()
              + (dt.numel() + A.numel() + D.numel()) * 4 + bt * h * n * p * 4)
    rows = [min(chunk, s - c0) for c0 in range(0, s, chunk)]
    pairs = sum(q * (q + 1) // 2 for q in rows)
    ops = bt * h * (2 * (n + p) * pairs + 4 * n * p * s)
    return nbytes, ops


def time_ssd(dev):
    """Kernel and plain times at the prefill's shape, cycling over three
    input sets (81 MB in bf16, past the 50 MB L2), as each layer's scan
    finds its inputs cold: bf16 through the variant the wrapper picks (the
    tensor cores) and forced to the CUDA cores, and f32 (the CUDA cores).
    No single PyTorch call computes the scan, so K5 has no library time."""
    import torch
    from repro_torch.kernels.mamba2_ssd import kernel as K5
    from repro_torch.kernels.mamba2_ssd import ref
    main = {k: v for k, v in SSD_SHAPE.items() if k != "chunk"}
    chunk = SSD_SHAPE["chunk"]
    xs = [ssd_case(83 + i, torch.bfloat16, dev, **main) for i in range(3)]
    it = itertools.count()

    def pick(sets=xs):
        return sets[next(it) % len(sets)]
    out = {"k5": timed(lambda: K5.ssd(*pick(), chunk=chunk)),
           "k5_cuda_core": timed(lambda: K5.ssd(*pick(), chunk=chunk,
                                                variant="cuda_core")),
           "k5_plain": timed(lambda: ref.ssd_chunked(*pick(), chunk=chunk),
                             iters=10)}
    nbytes, ops = ssd_work(xs[0], chunk)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS_PER_S
    out.update(k5_bound_ms=max(t_bytes, t_ops) * 1e3,
               k5_bound_by="bytes" if t_bytes >= t_ops else "operations",
               k5_bytes=nbytes, k5_ops=ops)
    del xs
    f32 = [ssd_case(89 + i, torch.float32, dev, **main) for i in range(3)]
    out["k5_f32"] = timed(lambda: K5.ssd(*pick(f32), chunk=chunk))
    return out


# -- phase 10 ------------------------------------------------------------------

def mamba_cfg(dtype: str, **kw):
    """mamba2-780m at full width in ``dtype`` (batch layout)."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("mamba2-780m"), param_dtype=dtype,
                               compute_dtype=dtype, **kw)


def rel_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def ssm_prefill_profile(model, batch, variant=None):
    """Where a mamba2 prefill's time goes, in a steady state: wall and
    device ms per prefill, the busy share and K5's device ms (its pre-pass
    included).  ``variant`` forces K5's variant for the run (the CUDA
    cores: the kernel of the tree before the tensor-core variant)."""
    import torch
    from repro_torch.kernels.mamba2_ssd import kernel as K5
    pick = K5.variant_for
    if variant is not None:
        K5.variant_for = lambda *a, **kw: variant
    try:
        model.prefill(batch, PREFILL_MAX_LEN)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            model.prefill(batch, PREFILL_MAX_LEN)
        torch.cuda.synchronize()
        steady_ms = (time.perf_counter() - t0) / 3 * 1e3
        dev_ms, by_name = device_profile(
            lambda: model.prefill(batch, PREFILL_MAX_LEN), iters=3, warmup=0)
    finally:
        K5.variant_for = pick
    return {"steady_prefill_ms": steady_ms, "device_ms_per_prefill": dev_ms,
            "busy_share": None if dev_ms is None else dev_ms / steady_ms,
            "k5_device_ms_per_prefill": sum(
                v for k, v in by_name.items()
                if any(sym in k for sym in KERNEL_SYMBOLS["ssd"]))}


def ssd_rounded(x, dt, A, B, C, D, chunk, split):
    """``ref.ssd_chunked``'s algebra (S a multiple of ``chunk``) with the f32
    operands of the tensor-core variant's products rounded as that variant
    rounds them: the decay-weighted C B^T tile, the incoming state and x w
    (w_s = exp(L_end - L_s) dt_s), each as bf16 hi + lo (``split``) or as
    bf16 alone (a kernel without the split); x, B and C are bf16 already.
    Returns (y in x's dtype, the f32 final state)."""
    import torch
    from repro_torch.kernels.mamba2_ssd import ref

    def rnd(t):
        hi = t.bfloat16().float()
        return hi + (t - hi).bfloat16().float() if split else hi
    bt, s, h, p = x.shape
    n, nc = B.shape[-1], s // chunk
    xc = x.float().reshape(bt, nc, chunk, h, p)
    bc = ref._expand_groups(B, h).float().reshape(bt, nc, chunk, h, n)
    cc = ref._expand_groups(C, h).float().reshape(bt, nc, chunk, h, n)
    dtc = dt.float().reshape(bt, nc, chunk, h)
    L = torch.cumsum(dtc * A, dim=2)
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                 device=x.device))[None, None, :, :, None]
    diff = torch.where(mask, L[:, :, :, None] - L[:, :, None], 0.0)
    cb = torch.einsum("bcthn,bcshn->bctsh", cc, bc)
    tile = torch.where(mask, cb * torch.exp(diff) * dtc[:, :, None], 0.0)
    del diff, cb
    y = torch.einsum("bctsh,bcshp->bcthp", rnd(tile), xc)
    del tile
    state = torch.zeros(bt, h, n, p, device=x.device)
    for c in range(nc):
        y[:, c] += torch.exp(L[:, c])[..., None] * torch.einsum(
            "bthn,bhnp->bthp", cc[:, c], rnd(state))
        w = torch.exp(L[:, c, -1:] - L[:, c]) * dtc[:, c]
        upd = torch.einsum("bthn,bthp->bhnp", bc[:, c],
                           rnd(xc[:, c] * w[..., None]))
        state = state * torch.exp(L[:, c, -1])[..., None, None] + upd
    y = y.reshape(bt, s, h, p) + x.float() * D[None, None, :, None]
    return y.to(x.dtype), state


def ssm_k5_inputs(model, batch, layers: int):
    """The inputs K5 is given in the first ``layers`` layers of one prefill
    of ``batch`` (copies), with their chunk."""
    from repro_torch.kernels.mamba2_ssd import kernel as K5
    got, launch = [], K5.ssd

    def capture(*args, chunk, variant=None):
        if len(got) < layers:
            got.append(([a.clone() for a in args], chunk))
        return launch(*args, chunk=chunk, variant=variant)
    K5.ssd = capture
    try:
        model.prefill(batch, PREFILL_MAX_LEN)
    finally:
        K5.ssd = launch
    return got


def ssd_readings(got, want, dtype: str) -> dict:
    """``got`` against ``want`` (each (y, final state)): the shares of y
    and state outside SSD_TOL, and the largest difference of each over its
    max |want|."""
    rtol_y, atol_y, tol_state = SSD_TOL[dtype]
    out = {}
    for key, g, w, rtol, atol in (("y", got[0], want[0], rtol_y, atol_y),
                                  ("state", got[1], want[1], tol_state,
                                   tol_state)):
        g, w = g.float(), w.float()
        d = (g - w).abs()
        out[f"{key}_outside"] = (d > atol + rtol * w.abs()).float().mean().item()
        out[f"{key}_rel"] = (d.max() / w.abs().max()).item()
    return out


def ssm_k5_real(model, batch, layers: int = SSM_REAL_LAYERS,
                bf16_gate: bool = True, floors=None):
    """K5 on the real inputs of the first ``layers`` SSM layers of a bf16
    prefill, captured from the kernel path (so each layer's inputs carry
    K5's output of the layer before), against ref.ssd_chunked: the final
    state within SSD_TOL, and no larger a share of y outside SSD_TOL than
    SSM_ORDER_FACTOR times the plain version's own at half the chunk.  (The
    real cumulative sums leave y ill-conditioned: ~1.4e-4 of it lies
    outside SSD_TOL for the f32 CUDA-core variant as for the tensor cores,
    ~7e-5 for the plain version at half the chunk.)  The same gates must
    fail on the products rounded to bf16 alone (``ssd_rounded``), or they
    could not see a kernel without the split (with ``bf16_gate`` off that
    is only reported, as ``bf16_only_passes``).  With ``floors`` (names of
    the readings below) the state and y shares are each limited instead to
    SSM_ORDER_FACTOR times the largest share of those readings.  Returns
    the readings per layer: the kernel through the variant the wrapper picks (the tensor
    cores), the CUDA-core variant, the plain version at half the chunk and
    the products rounded to bf16 alone and split."""
    import torch
    from repro_torch.kernels.mamba2_ssd import kernel as K5
    from repro_torch.kernels.mamba2_ssd import ref
    out = []
    for layer, (args, chunk) in enumerate(
            ssm_k5_inputs(model, batch, layers)):
        want = ref.ssd_chunked(*args, chunk=chunk)
        tc = K5.LAUNCHES["ssd_tc"]
        got = {"kernel": K5.ssd(*args, chunk=chunk)}
        if K5.LAUNCHES["ssd_tc"] != tc + 1:
            raise AssertionError("K5 on real bf16 inputs: not the tensor cores")
        got["cuda_core"] = K5.ssd(*args, chunk=chunk, variant="cuda_core")
        got["plain_half_chunk"] = ref.ssd_chunked(*args, chunk=chunk // 2)
        got["split"] = ssd_rounded(*args, chunk, True)
        got["bf16_only"] = ssd_rounded(*args, chunk, False)
        torch.cuda.synchronize()
        r = {k: ssd_readings(v, want, "bfloat16") for k, v in got.items()}
        r["max_abs"] = {"y": want[0].float().abs().max().item(),
                        "state": want[1].abs().max().item()}
        del want, got
        if floors is None:
            lim = {"state": 0.0, "y": SSM_ORDER_FACTOR
                   * r["plain_half_chunk"]["y_outside"]}
        else:
            lim = {k: SSM_ORDER_FACTOR * max(r[f][f"{k}_outside"]
                                             for f in floors)
                   for k in ("y", "state")}
        r["limit_outside"] = lim

        def passes(x):
            return (x["state_outside"] <= lim["state"]
                    and x["y_outside"] <= lim["y"])
        if not passes(r["kernel"]):
            raise AssertionError(
                f"K5 on layer {layer}'s real inputs against ref.ssd_chunked "
                f"(shares outside SSD_TOL limited to {lim}): {r}")
        r["bf16_only_passes"] = passes(r["bf16_only"])
        if bf16_gate and r["bf16_only_passes"]:
            raise AssertionError(
                f"K5's real-input gate at layer {layer} passes bf16 operands "
                f"alone: {r['bf16_only']}")
        out.append(r)
    return out


def ssm_bf16_only_cache(model, batch):
    """The prefill's ssd cache with K5 replaced by ``ssd_rounded`` with bf16
    operands alone: what a kernel without the split would leave."""
    from repro_torch.kernels.mamba2_ssd import kernel as K5
    launch = K5.ssd
    K5.ssd = lambda *a, chunk, variant=None: ssd_rounded(*a, chunk, False)
    try:
        _, cache = model.prefill(batch, PREFILL_MAX_LEN)
    finally:
        K5.ssd = launch
    return cache["b0"]["ssd"]


def phase_ssm_prefill(dev, dtype: str):
    """Full-width mamba2-780m prefill of 8 x 512 and 8 x 511 tokens with K5
    (attn_impl "pallas"): K5 launched once per layer per call, in bf16 on
    the tensor cores.  Against the plain path ("ref"): layer 0's conv and
    ssd cache within LOGIT_RTOL; in f32 the logits and every layer's cache,
    in bf16 the logits, within the larger of LOGIT_RTOL and SSM_ORDER_FACTOR
    times the plain path's own half-chunk disagreement.  In bf16 at 8 x
    512, layer 0's ssd cache within SSM_ORDER_FACTOR times that
    disagreement at layer 0, and K5 on the real inputs of the first
    layers (ssm_k5_real); both must fail with bf16 operands alone.  In f32
    prefill(510) plus one decode step reproduces prefill(511) to the same
    limit; in bf16 a steady-state device profile of the 8 x 512 prefill,
    and the same with K5 forced to the CUDA cores.  Returns (K5 launches
    of the 8 x 512 prefill, results)."""
    import torch
    from repro_torch.kernels.mamba2_ssd import kernel as K5
    from repro_torch.models import transformer as T
    from repro_torch.models.model import Model
    cfg = mamba_cfg(dtype, attn_impl="pallas")
    model = Model(cfg, device=dev, seed=0)
    rng = np.random.default_rng(9)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size,
                                     (PREFILL_B, PREFILL_MAX_LEN)), device=dev)
    model.prefill({"tokens": toks[:, :16]}, PREFILL_MAX_LEN)   # warm up
    vocab = cfg.vocab_size          # the padded columns hold -1e30
    res, main_launches, logits511 = {"dtype": dtype}, None, None
    order_floor = None
    for s in (PREFILL_MAX_LEN, PREFILL_S):
        batch = {"tokens": toks[:, :s]}
        torch.cuda.synchronize()
        K5.reset_launch_counts()
        t0 = time.perf_counter()
        logits, cache = model.prefill(batch, PREFILL_MAX_LEN)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches, tc = K5.LAUNCHES["ssd"], K5.LAUNCHES["ssd_tc"]
        if launches != cfg.n_layers:
            raise AssertionError(f"ssd: {launches} launches in one prefill of "
                                 f"{cfg.n_layers} layers")
        # bf16 goes to the tensor cores (P 64, N 128, chunk 128), f32 to the
        # CUDA cores
        if tc != (cfg.n_layers if dtype == "bfloat16" else 0):
            raise AssertionError(f"ssd: {tc} tensor-core launches in one "
                                 f"{dtype} prefill of {cfg.n_layers} layers")
        if not bool(torch.isfinite(logits[:, :vocab]).all()):
            raise AssertionError(f"prefill of {s} ({dtype}): logits not finite")
        main_launches = main_launches or launches
        r = {"prefill_ms": wall_ms, "ssd_launches": launches,
             "ssd_tc_launches": tc,
             "prompt_tokens_per_s": PREFILL_B * s / wall_ms * 1e3}
        plain = {}
        for chunk in (cfg.ssd_chunk, cfg.ssd_chunk // 2):
            t0 = time.perf_counter()
            pl, pc = T.prefill(
                dataclasses.replace(cfg, attn_impl="ref", ssd_chunk=chunk),
                model.params, batch, PREFILL_MAX_LEN, periods=model.periods())
            torch.cuda.synchronize()
            r.setdefault("plain_prefill_ms", (time.perf_counter() - t0) * 1e3)
            plain[chunk] = {"logits": pl[:, :vocab], **pc["b0"]}
        ref, other = plain[cfg.ssd_chunk], plain[cfg.ssd_chunk // 2]
        got = {"logits": logits[:, :vocab], **cache["b0"]}
        gated = list(got) if dtype == "float32" else ["logits"]
        rel = {k: rel_err(got[k], ref[k]) for k in gated}
        floor = {k: rel_err(other[k], ref[k]) for k in gated}
        layer0 = {k: rel_err(got[k][0], ref[k][0]) for k in ("conv", "ssd")}
        for what, e in layer0.items():
            if not np.isfinite(e) or e > LOGIT_RTOL[dtype]:
                raise AssertionError(
                    f"ssm prefill layer 0 {what} (S={s}, {dtype}): kernel vs "
                    f"plain {e} of max |value| > {LOGIT_RTOL[dtype]}")
        for what, e in rel.items():
            lim = max(LOGIT_RTOL[dtype], SSM_ORDER_FACTOR * floor[what])
            if not np.isfinite(e) or e > lim:
                raise AssertionError(
                    f"ssm prefill {what} (S={s}, {dtype}): kernel vs plain "
                    f"{e} of max |value| > {lim} (plain vs plain "
                    f"{floor[what]})")
        r.update(rel=rel, rel_layer0=layer0, rel_plain_half_chunk=floor)
        order_floor = floor["logits"]
        if dtype == "bfloat16" and s == PREFILL_MAX_LEN:
            # layer 0's ssd cache (the same inputs on both paths) also
            # within SSM_ORDER_FACTOR times the plain path's own half-chunk
            # disagreement there; a path with bf16 operands alone must fail
            # it.  Later layers' caches carry y's bf16 roundings from the
            # layer before, as large on the plain path (information only):
            # ssm_k5_real holds K5 at those layers instead.
            r["k5_real"] = ssm_k5_real(model, batch)
            only = ssm_bf16_only_cache(model, batch)
            r["ssd_layers"] = {
                name: [rel_err(c[i], ref["ssd"][i])
                       for i in range(min(SSM_REAL_LAYERS, cfg.n_layers))]
                for name, c in (("kernel", got["ssd"]),
                                ("plain_half_chunk", other["ssd"]),
                                ("bf16_only", only))}
            del only
            lay = r["ssd_layers"]
            lim = SSM_ORDER_FACTOR * lay["plain_half_chunk"][0]
            if not lay["kernel"][0] <= lim:
                raise AssertionError(
                    f"ssm prefill layer 0 ssd (bf16): kernel vs plain "
                    f"{lay['kernel'][0]} of max |value| > {lim}")
            if lay["bf16_only"][0] <= lim:
                raise AssertionError(
                    f"ssm prefill layer 0 ssd gate ({lim}) passes bf16 "
                    f"operands alone ({lay['bf16_only'][0]})")
        del plain, ref, other
        if dtype == "bfloat16" and s == PREFILL_MAX_LEN:
            r["profile"] = ssm_prefill_profile(model, batch)
            r["profile_cuda_core"] = ssm_prefill_profile(model, batch,
                                                         "cuda_core")
        res[f"s{s}"] = r
        logits511 = logits
        del cache
    if dtype == "float32":
        # prefill(S-1) + one decode step == prefill(S) at S = 511
        _, short = model.prefill({"tokens": toks[:, :PREFILL_S - 1]},
                                 PREFILL_MAX_LEN)
        lengths = torch.full((PREFILL_B,), PREFILL_S, dtype=torch.int32,
                             device=dev)
        dec, _ = model.decode_step(
            toks[:, PREFILL_S - 1:PREFILL_S].to(torch.int32), short, lengths)
        e = rel_err(dec[:, :vocab], logits511[:, :vocab])
        lim = max(LOGIT_RTOL[dtype], SSM_ORDER_FACTOR * order_floor)
        if not np.isfinite(e) or e > lim:
            raise AssertionError(f"ssm prefill + decode vs prefill: rel {e} "
                                 f"> {lim}")
        res["rel_prefill_plus_decode"] = e
        del short
    del model
    torch.cuda.empty_cache()
    return main_launches, res


# -- phase 11 ------------------------------------------------------------------

#: the batch layout, as the serve CLI runs it (no frames: nothing to retain)
SSM_SERVE_ENGINE = dict(slots=8, max_len=512, max_fused_steps=8)
#: f32 fused against stepwise: the phase-4 trace cut to its first requests
SSM_TOKENS_REQUESTS = 4


def phase_ssm_serve(dev):
    """The phase-4 trace through the full-width mamba2-780m engine on the
    batch layout in bf16: every request completes and no kernel launches
    (the recurrent decode step is plain torch, prompts prefill through it);
    one profiled decode step; in f32 fused and stepwise runs serve
    identical per-uid tokens."""
    from repro_torch.kernels.flash_attention import kernel as K3
    from repro_torch.kernels.mamba2_ssd import kernel as K5
    from repro_torch.kernels.paged_decode import flash as K4
    from repro_torch.kernels.paged_decode import kernel as K
    mods = (K, K3, K4, K5)
    for mod in mods:
        mod.reset_launch_counts()
    cfg = mamba_cfg("bfloat16", attn_impl="pallas")
    trace = dict(SERVE_TRACE, vocab_size=cfg.vocab_size)
    outputs, stats, dt = serve_model(dev, cfg, SSM_SERVE_ENGINE, trace)
    launched = {k: n for mod in mods for k, n in mod.LAUNCHES.items() if n}
    if launched:
        raise AssertionError(f"SSM serving launched kernels: {launched}")
    new_tokens = sum(len(o) for o in outputs.values())
    res = {"completed": len(outputs), "new_tokens": new_tokens,
           "decode_steps": stats["decode_steps"],
           "dispatches": stats["dispatches"], "wall_s": dt,
           "tokens_per_s": new_tokens / dt,
           "decode_step_ms": dt / stats["decode_steps"] * 1e3,
           "weight_bytes": cfg.param_count() * 2,
           "weight_read_bound_ms": cfg.param_count() * 2 / HBM_BYTES_PER_S
           * 1e3,
           "p99_ttft_steps": stats["telemetry"]["ttft_steps"]["p99"],
           "mean_itl_steps": stats["telemetry"]["itl_steps"]["mean"],
           "profile": phase_profile(dev, "batch", cfg=cfg)}
    f32 = mamba_cfg("float32", attn_impl="pallas")
    short = dict(trace, n_requests=SSM_TOKENS_REQUESTS)
    runs = {n: serve_model(dev, f32, dict(SSM_SERVE_ENGINE,
                                          max_fused_steps=n), short)
            for n in (8, 1)}
    (fused, st_f, dt_f), (step, st_s, dt_s) = runs[8], runs[1]
    if fused != step:
        bad = sorted(u for u in fused if fused[u] != step.get(u))
        raise AssertionError(f"f32 SSM tokens differ, fused vs stepwise, for "
                             f"uids {bad}")
    # tokens only: on this trace the reference's own fused and stepwise
    # runs differ in decode steps and inter-token gaps (admission timing),
    # and the port reproduces each of them (tests/test_torch_ssm.py)
    res.update(f32_tokens_identical=len(fused),
               f32_new_tokens=sum(len(o) for o in fused.values()),
               f32_decode_steps={"fused": st_f["decode_steps"],
                                 "stepwise": st_s["decode_steps"]},
               f32_dispatches={"fused": st_f["dispatches"],
                               "stepwise": st_s["dispatches"]},
               f32_fused_s=dt_f, f32_stepwise_s=dt_s)
    return res


# -- phase 12 ------------------------------------------------------------------

#: the reference's production-scale emulated memory
#: (benchmarks/emem_bench.py:36-38): 2^24 slots of 128 f32 in pages of 256
#: slots, 8 GiB on the card, 65536 pages; used as 1 and as 16 shards
EMEM_SPEC = dict(n_slots=1 << 24, width=128, page_slots=256)
EMEM_SHARDS = (1, 16)
#: requests per shard and capacity factor of emem_bench.py:38-39
EMEM_REQUESTS, EMEM_CF = 4096, 1.5
#: dependent hops of the pointer chase (examples/emulated_memory_demo.py)
CHASE_HOPS = 1024
#: K7 and K6 at the paths' shapes: 65536 slots (an emem batch at 16
#: shards), 1 page (a swap-out), 16 pages (a 16-set cache fill), 4096 pages
#: (bulk)
GATHER_SLOTS, GATHER_SWAP, GATHER_FILL, GATHER_BULK = 65536, 1, 16, 4096
#: a page K6 cuts into chunks that do not divide it: 255 x 127 elements
#: are 32385 units (of 4 bytes in f32, of 2 in bf16), in chunks of 128
#: units for 1 page (254 chunks) and of 1920 for 16 (17 chunks), by
#: gather.cu's rule
GATHER_ODD_PAGE = (255, 127)


def emem_store(dev, seed: int, dtype=None):
    """The production-scale store [65536, 256, 128], filled from a seeded
    generator on the card."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (EMEM_SPEC["n_slots"] // EMEM_SPEC["page_slots"],
             EMEM_SPEC["page_slots"], EMEM_SPEC["width"])
    data = torch.empty(shape, dtype=torch.float32, device=dev)
    data.normal_(generator=g)
    return data if dtype is None else data.to(dtype)


def same_bits(a, b) -> bool:
    import torch
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.contiguous().view(torch.uint8),
                            b.contiguous().view(torch.uint8)))


def check_gathers(pages, slots, ids, what):
    """K7 and K6 against their plain versions, bit for bit."""
    import torch
    from repro_torch.kernels.paged_decode import gather as K67
    from repro_torch.kernels.paged_decode import gather_ref
    dev = pages.device
    slots = torch.as_tensor(slots, dtype=torch.int32, device=dev)
    ids = torch.as_tensor(ids, dtype=torch.int32, device=dev)
    for name, kern, plain, idx in (
            ("K7", K67.gather_slots, gather_ref.gather_slots, slots),
            ("K6", K67.gather_pages, gather_ref.gather_pages, ids)):
        got, want = kern(pages, idx), plain(pages, idx)
        torch.cuda.synchronize()
        if not same_bits(got, want):
            raise AssertionError(f"{name} differs from its plain version: "
                                 f"{what}, {pages.dtype} "
                                 f"{tuple(pages.shape)}")


def phase_gather(dev):
    """K7 and K6 against their plain versions bit for bit: the reference
    tests' sweep shapes (tests/test_kernels.py:21-42) with rows of 1, 3 and
    4 elements, f32, bf16, an int32 page-table store and a uint8 store
    (every copy unit, 16 bytes down to 1), empty (-1), repeated and
    past-the-end indices; K6 on pages that its chunks do not divide; then
    the paths' shapes on the 8 GiB store (65536 slots; 1, 16 and 4096
    pages, with empty and past-the-end ids), in f32 and bf16, and their
    times."""
    import torch
    rng = np.random.default_rng(89)
    for dtype in (torch.float32, torch.bfloat16, torch.int32, torch.uint8):
        for n_pages, ps, w in ((4, 8, 16), (8, 16, 4), (2, 32, 128),
                               (6, 8, 1), (5, 4, 3), (3, 128, 1)):
            pages = torch.tensor(rng.normal(size=(n_pages, ps, w)) * 100,
                                 device=dev).to(dtype)
            n = n_pages * ps
            slots = np.concatenate([rng.integers(0, n, 17),
                                    [-1, 3, 3, n - 1, n, 2 ** 30, -7]])
            ids = [n_pages - 1, -1, 0, 2, 0, n_pages, -5]
            check_gathers(pages, slots, ids, "sweep")
            # a store that starts one row in: other alignments
            check_gathers(pages.view(n, 1, w)[1:], slots % (n - 1),
                          [0, 3, -1], "offset store")
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        odd = torch.tensor(rng.normal(size=(64, *GATHER_ODD_PAGE)),
                           device=dev).to(dtype)
        for p in (GATHER_SWAP, GATHER_FILL):
            for ids in page_ids(rng, len(odd), p):
                check_gathers(odd, [0, -1], ids, f"odd page, {p} pages")
        del odd
        store = emem_store(dev, 97, dtype)
        n_pages, ps, _ = store.shape
        g = torch.Generator(device=dev).manual_seed(101)
        slots = torch.randint(0, n_pages * ps, (GATHER_SLOTS,), generator=g,
                              device=dev, dtype=torch.int32)
        slots[::97] = -1
        slots[1::89] = slots[0]
        check_gathers(store, slots, [0], "paths' shapes, 65536 slots")
        for p in (GATHER_SWAP, GATHER_FILL, GATHER_BULK):
            for ids in page_ids(rng, n_pages, p):
                check_gathers(store, [0], ids, f"paths' shapes, {p} pages")
        if dtype == torch.float32:
            out = time_gathers(store, slots, g)
        del store
        torch.cuda.empty_cache()
    return {"k6": 0.0, "k7": 0.0}, out


def page_ids(rng, n_pages, p):
    """K6 index sets of ``p`` pages with an empty (-1) and a past-the-end
    id: one set for ``p`` > 2, else one set each (a random id first)."""
    ids = rng.integers(0, n_pages, p)
    if p < 3:
        return [ids, np.full(p, -1), np.full(p, n_pages + 3)]
    ids[1], ids[2] = -1, n_pages + 3
    return [ids]


def time_gathers(store, slots, g):
    """Kernel, plain and library times of K7 (65536 slots) and K6 (1, 16
    and 4096 pages) on the 8 GiB f32 store; every index is drawn uniformly,
    and K6 cycles over sets of page ids that together pass the 50 MB L2, so
    every row or page is read cold.  K6 at 1 and 16 pages is also timed
    warm (``_warm``: the same ids every call, which leaves them in the L2).
    The library call is ``index_select`` on indices clamped beforehand: it
    does not zero the empty ones, so it is a yardstick, not the same
    function."""
    import torch
    from repro_torch.kernels.paged_decode import gather as K67
    from repro_torch.kernels.paged_decode import gather_ref
    n_pages, ps, w = store.shape
    flat = store.view(-1, w)
    row = w * store.element_size()
    out = {"k7": timed(lambda: K67.gather_slots(store, slots)),
           "k7_plain": timed(lambda: gather_ref.gather_slots(store, slots))}
    clamped = slots.long().clamp(min=0)
    out["k7_library"] = timed(lambda: flat.index_select(0, clamped))
    k7_bytes = slots.numel() * (4 + 2 * row)
    it = itertools.count()
    for p, key in ((GATHER_BULK, "k6"), (GATHER_FILL, "k6_fill"),
                   (GATHER_SWAP, "k6_swap")):
        n_sets = -(-(128 << 20) // (p * ps * row))      # 128 MB of pages
        sets = [torch.randint(0, n_pages, (p,), generator=g,
                              device=store.device, dtype=torch.int32)
                for _ in range(n_sets)]
        lib_sets = [ids.long() for ids in sets]

        def pick(xs):
            return xs[next(it) % len(xs)]
        out[key] = timed(lambda: K67.gather_pages(store, pick(sets)),
                         iters=20)
        out[f"{key}_plain"] = timed(
            lambda: gather_ref.gather_pages(store, pick(sets)), iters=20)
        out[f"{key}_library"] = timed(
            lambda: store.index_select(0, pick(lib_sets)), iters=20)
        if n_sets > 1:
            out[f"{key}_warm"] = timed(
                lambda: K67.gather_pages(store, sets[0]), iters=20)
            out[f"{key}_library_warm"] = timed(
                lambda: store.index_select(0, lib_sets[0]), iters=20)
        out[f"{key}_bytes"] = p * (4 + 2 * ps * row)
        out[f"{key}_bound_ms"] = out[f"{key}_bytes"] / HBM_BYTES_PER_S * 1e3
    out.update(k7_bytes=k7_bytes,
               k7_bound_ms=k7_bytes / HBM_BYTES_PER_S * 1e3)
    return out


# -- phase 13 ------------------------------------------------------------------

def wall_us(fn, iters: int = 10):
    """Median host time of ``fn()`` in microseconds, each call ending in a
    device synchronise (end to end, as a caller waits for it)."""
    import torch
    fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e6)
    return float(np.median(times))


def emem_batch(dev, spec, g, cf):
    """A batch of ``EMEM_REQUESTS`` uniform requests per shard with repeated
    addresses, its values, and the per-request drop mask of the port's
    ``_plan`` at capacity factor ``cf``."""
    import torch
    from repro_torch.core import emem
    r = EMEM_REQUESTS * spec.n_shards
    addrs = torch.randint(0, spec.n_slots, (r,), generator=g, device=dev,
                          dtype=torch.int32)
    addrs[r // 2:r // 2 + 64] = addrs[:64]          # repeated in one batch
    addrs[7::1024] = addrs[3]
    vals = torch.randn((r, spec.width), generator=g, device=dev)
    cap = emem.capacity_for(spec, EMEM_REQUESTS, cf)
    valid = (emem._plan(spec, addrs.view(spec.n_shards, -1), cap).valid
             .reshape(-1) if spec.n_shards > 1
             else torch.ones(r, dtype=torch.bool, device=dev))
    return addrs, vals, valid


def phase_emem(dev):
    """Random read/write of the 8 GiB store as 1 and as 16 emulated shards,
    4096 requests per shard at capacity factor 1.5, held against
    read_ref/write_ref on a logical copy (a write batch repeats addresses);
    at 16 shards and factor 1.0 the overflow drops exactly the requests the
    port's _plan marks invalid; then a pointer chase of 1024 dependent hops,
    one K7 launch each.  Returns (K7 launches of the driven reads and
    writes, results)."""
    import torch
    from repro_torch.core import emem
    from repro_torch.kernels.paged_decode import gather as K67
    res, launches = {}, 0
    for n_shards in EMEM_SHARDS:
        spec = emem.EMemSpec(**EMEM_SPEC, n_shards=n_shards)
        data = emem_store(dev, 103)                 # physical page order
        logical = emem.to_logical(spec, data)
        g = torch.Generator(device=dev).manual_seed(107 + n_shards)
        cfs = (EMEM_CF, 1.0) if n_shards > 1 else (EMEM_CF,)
        for cf in cfs:
            addrs, vals, valid = emem_batch(dev, spec, g, cf)
            K67.reset_launch_counts()
            got = emem.read(spec, data, addrs, cf)
            emem.write(spec, data, addrs, vals, cf)
            torch.cuda.synchronize()
            launches += K67.LAUNCHES["gather_slots"]
            want = emem.read_ref(spec, logical, addrs).masked_fill(
                ~valid[:, None], 0)
            if not same_bits(got, want):
                raise AssertionError(f"emem read differs from read_ref: "
                                     f"{n_shards} shards, cf {cf}")
            emem.write_ref(spec, logical, addrs[valid], vals[valid])
            if not same_bits(emem.to_logical(spec, data), logical):
                raise AssertionError(f"emem write differs from write_ref: "
                                     f"{n_shards} shards, cf {cf}")
            dropped = int((~valid).sum())
            if cf == 1.0 and not dropped:
                raise AssertionError("capacity factor 1.0 dropped nothing")
            res[f"s{n_shards}_cf{cf}_dropped"] = dropped
        addrs, vals, _ = emem_batch(dev, spec, g, EMEM_CF)
        n = addrs.numel()
        payload = n * spec.width * 4
        us_r = wall_us(lambda: emem.read(spec, data, addrs, EMEM_CF))
        us_w = wall_us(lambda: emem.write(spec, data, addrs, vals, EMEM_CF))

        def read():
            return emem.read(spec, data, addrs, EMEM_CF)

        # device time from the queued-event clock where nothing syncs
        # (timed); the profiler keeps no record of a short window at times
        # (read_profiler_records: at 1 shard a read is one K7 launch)
        dev_r = timed(read, iters=10)
        dev_w = timed(lambda: emem.write(spec, data, addrs, vals, EMEM_CF),
                      iters=10)
        res[f"s{n_shards}"] = {
            "requests": n, "read_us": us_r, "write_us": us_w,
            "read_device_us": dev_r["device_ms"] * 1e3,
            "write_device_us": dev_w["device_ms"] * 1e3,
            "read_clocks": dev_r, "write_clocks": dev_w,
            "read_requests_per_s": n / us_r * 1e6,
            "write_requests_per_s": n / us_w * 1e6,
            "read_gb_per_s": payload / us_r / 1e3,
            "write_gb_per_s": payload / us_w / 1e3,
            "stats": emem.dispatch_stats(spec, EMEM_REQUESTS, EMEM_CF)}
        del logical
        if n_shards == 1:
            res["s1"]["read_profiler_records"] = {
                iters: profiler_records(read, iters) for iters in (1, 10, 100)}
            res["chase"], hops = pointer_chase(dev, spec, data)
            launches += hops
        del data
        torch.cuda.empty_cache()
    return launches, res


def pointer_chase(dev, spec, data):
    """The sequential client of examples/emulated_memory_demo.py:33-55 on
    the 8 GiB store: column 0 of every slot holds the next address (a
    seeded permutation, exact in f32 below 2^24), and each hop reads one
    slot through emem.read -- one K7 launch -- with the address kept on the
    card.  Returns (results, K7 launches)."""
    import torch
    from repro_torch.core import emem
    from repro_torch.kernels.paged_decode import gather as K67
    g = torch.Generator(device=dev).manual_seed(109)
    perm = torch.randperm(spec.n_slots, generator=g, device=dev)
    data.view(-1, spec.width)[:, 0] = perm.float()

    def chase():
        addr = torch.zeros(1, dtype=torch.int32, device=dev)
        for _ in range(CHASE_HOPS):
            addr = emem.read(spec, data, addr)[:, 0].to(torch.int32)
        return addr
    chase()                                         # warm up
    torch.cuda.synchronize()
    K67.reset_launch_counts()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t = time.perf_counter()
    start.record()
    addr = chase()
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = K67.LAUNCHES["gather_slots"]
    if launches != CHASE_HOPS:
        raise AssertionError(f"pointer chase: {launches} K7 launches for "
                             f"{CHASE_HOPS} hops")
    dev_ms, _ = device_profile(chase, iters=1, warmup=0)
    host = perm.cpu().numpy()
    a = 0
    for _ in range(CHASE_HOPS):
        a = int(host[a])
    if int(addr[0]) != a:
        raise AssertionError(f"pointer chase ended at {int(addr[0])}, the "
                             f"host's chase at {a}")
    return {"hops": CHASE_HOPS, "ns_per_hop": wall / CHASE_HOPS * 1e9,
            "event_ns_per_hop": start.elapsed_time(end) / CHASE_HOPS * 1e6,
            "device_ns_per_hop": (None if dev_ms is None
                                  else dev_ms / CHASE_HOPS * 1e6),
            "end": a}, launches


# -- phase 14 ------------------------------------------------------------------

#: EMemVM over the 8 GiB spec: 4096 requests per batch, caches of 0 and 16
#: sets (benchmarks/vm_bench.py:63-69), a host store of 8 pages that spills.
#: The virtual space is twice the physical one (tests/test_emem_vm.py's
#: make_vm), so that the 65535 usable frames can all be mapped while pages
#: are swapped out: with 65535 virtual pages the pool can never be full
#: while one is on the host, and no fault would have to evict.
VM_REQUESTS, VM_CACHE_SETS, VM_HOST_PAGES = 4096, (0, 16), 8
VM_ROUNDS = 5


def vm_run(vm, seed: int, check_launches: bool):
    """One seeded sequence on ``vm``: the whole pool mapped, VM_ROUNDS of
    vwrite/vread/vread over mapped pages (repeated addresses in each write),
    unmap of 64 pages and remap onto their frames, a read-only page whose
    writes drop, 12 swap-outs through the 8-page host store into the spill
    tier, 12 new mappings (the pool full again), reads that fault 8 pages
    back (each evicting an LRU victim), a write, flush.  Returns (vread
    outputs, counters, stats, median vread us, median vwrite us, K7 and K6
    launches).  With ``check_launches`` every vread must launch K7 once and
    K6 once per cache fill and per swap-out it caused; every vwrite K6
    once per swap-out and K7 never; every swap-out K6 once."""
    import torch
    from repro_torch.emem_vm import PROT_R
    from repro_torch.kernels.paged_decode import gather as K67
    rng = np.random.default_rng(seed)
    cfg, dev = vm.cfg, vm.device
    ps, w = cfg.spec.page_slots, cfg.spec.width
    usable = vm.allocator.n_frames
    outs, times = [], {"vread": [], "vwrite": []}
    tally = {"gather_slots": 0, "gather_pages": 0}

    def op(name, fn, k7, fills, *args):
        swaps = vm.swap_counters["swap_outs"]
        K67.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        times.setdefault(name, []).append((time.perf_counter() - t) * 1e6)
        want = {"gather_slots": k7, "gather_pages":
                fills + vm.swap_counters["swap_outs"] - swaps}
        if check_launches and K67.LAUNCHES != want:
            raise AssertionError(f"{name} launched {K67.LAUNCHES}, not {want}")
        for k, n in K67.LAUNCHES.items():
            tally[k] += n
        return out

    def vread(addrs):
        outs.append(op("vread", vm.vread, 1, 1 if cfg.cache_sets else 0,
                       addrs))

    def vwrite(addrs, vals):
        op("vwrite", vm.vwrite, 0, 0, addrs, vals)

    def batch():
        return torch.tensor(rng.integers(0, usable * ps, VM_REQUESTS),
                            dtype=torch.int32, device=dev)

    def values(n=VM_REQUESTS):
        return torch.tensor(rng.normal(size=(n, w)), dtype=torch.float32,
                            device=dev)

    vm.map_range(0, usable)
    for _ in range(VM_ROUNDS):
        addrs = batch()
        addrs[1:64] = addrs[0]
        vwrite(addrs, values())
        vread(addrs)
        vread(batch())
    for vp in range(0, 128, 2):
        vm.unmap_page(vp)
    vm.map_range(cfg.n_vpages - 64, 64)
    vm.protect(1, PROT_R)
    vwrite(torch.arange(ps, dtype=torch.int32, device=dev) + ps, values(ps))
    vread(batch())
    for vp in range(201, 213):
        op("swap_out", vm.swap_out, 0, 0, vp)
    vm.map_range(cfg.n_vpages - 128, 12)           # the pool full again
    for first in (201, 205):                       # spilled, then host pages
        addrs = batch()
        addrs[:4] = torch.arange(first, first + 4, device=dev) * ps + 3
        vread(addrs)
    vwrite(batch(), values())
    op("flush", vm.flush, 0, 0)
    return (outs, vm.counters(), vm.stats(), float(np.median(times["vread"])),
            float(np.median(times["vwrite"])), tally)


def vm_profile(vm):
    """Device time of one vread and one vwrite of VM_REQUESTS uniform
    requests over the mapped pages (torch.profiler), and the kernels that
    spend most of it."""
    import torch
    g = torch.Generator(device=vm.device).manual_seed(127)
    addrs = torch.randint(0, vm.allocator.n_frames * vm.cfg.spec.page_slots,
                          (VM_REQUESTS,), generator=g, device=vm.device,
                          dtype=torch.int32)
    vals = torch.randn((VM_REQUESTS, vm.cfg.spec.width), generator=g,
                       device=vm.device)
    out = {}
    for name, fn in (("vread", lambda: vm.vread(addrs)),
                     ("vwrite", lambda: vm.vwrite(addrs, vals))):
        ms, by_name = device_profile(fn, iters=10)
        ops = by_name.pop("device_ops_per_call", None)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
        out[f"{name}_device_us"] = None if ms is None else ms * 1e3
        out[f"{name}_device_ops"] = ops
        out[f"{name}_top_us"] = {k[:60]: v * 1e3 for k, v in top}
    return out


def phase_vm(dev):
    """EMemVM over the 8 GiB spec, sharded at 1 and 16 emulated shards,
    caches of 0 and 16 sets: the seeded sequence of vm_run on the sharded
    VM, whose gathers are K7 and K6, and on an unsharded twin (one logical
    store, the reference's read_ref/write_ref route) whose gathers take
    their plain versions; vread outputs, counters(), stats() and the final
    store (in logical page order) bit-identical.  Returns ({kernel:
    launches of the sharded VMs' runs}, results)."""
    import torch
    from repro_torch.core import emem
    from repro_torch.emem_vm import EMemVM, VMConfig
    from repro_torch.kernels.paged_decode import gather_ops, gather_ref
    launches = {"gather_slots": 0, "gather_pages": 0}
    res = {}
    for n_shards in EMEM_SHARDS:
        spec = emem.EMemSpec(**EMEM_SPEC, n_shards=n_shards)
        for sets in VM_CACHE_SETS:
            cfg = VMConfig(spec=spec, n_vpages=2 * spec.n_pages,
                           cache_sets=sets, n_host_pages=VM_HOST_PAGES)
            vm = EMemVM(cfg, sharded=True, device=dev)
            t = time.monotonic()
            kern = vm_run(vm, 113, check_launches=True)
            run_s = time.monotonic() - t
            for k, n in kern[5].items():
                launches[k] += n
            twin = EMemVM(cfg, sharded=False, device=dev)
            saved = gather_ops.gather_slots, gather_ops.gather_pages
            gather_ops.gather_slots = gather_ref.gather_slots
            gather_ops.gather_pages = gather_ref.gather_pages
            try:
                plain = vm_run(twin, 113, check_launches=False)
            finally:
                gather_ops.gather_slots, gather_ops.gather_pages = saved
            for i, (a, b) in enumerate(zip(kern[0], plain[0])):
                if not same_bits(a, b):
                    raise AssertionError(f"vread {i} differs from the plain "
                                         f"route: {n_shards} shards, {sets} "
                                         f"sets")
            if kern[1:3] != plain[1:3] or not same_bits(
                    emem.to_logical(spec, vm.data), twin.data):
                raise AssertionError(
                    f"EMemVM differs from the plain route: {n_shards} shards, "
                    f"{sets} sets: {kern[1:3]} vs {plain[1:3]}")
            c = kern[1]
            prof = vm_profile(vm)
            res[f"s{n_shards}_sets{sets}"] = {
                "vread_us": kern[3], "vwrite_us": kern[4], **prof,
                "hit_rate": c["hit_rate"], "hits": c["hits"],
                "misses": c["misses"], "faults": c["faults"],
                "swap_outs": c["swap_outs"], "spill_outs": c["spill_outs"],
                "spill_ins": c["spill_ins"], "vreads": len(kern[0]),
                "run_s": run_s}
            del vm, twin, kern, plain
            torch.cuda.empty_cache()
    return launches, res


# -- phase 15 ------------------------------------------------------------------

#: the sections whose engines serve through K1 and K2 (the pooled and
#: reserved layouts); ``paged_decode`` is the sweep, ``throughput`` EMemVM
VM_BENCH_SERVING = ("prefix_sharing", "swap", "tiered", "retention",
                    "scheduling", "slo", "dispatch")


def phase_vm_bench(dev):
    """benchmarks/vm_bench_torch.py at qwen3-0.6b's full width in f32: the
    reference's serving workloads with their traffic unchanged, every
    assertion of the reference held except the dispatch wall criterion,
    which is reported (``wall_criterion``), and the sweep's exact m,
    held to 1e-5 against the composed step (K2 sums each q.k in its own
    order).  Each pooled or reserved
    section's engines launched K1 and K2 once per layer and decode step,
    the sweep launched both (and agreed with the composed step), the
    EMemVM rows K6 and K7.  Returns ({kernel: launches on the path, the
    sweep's excluded}, results with the CPU headline of BENCH_vm.json
    beside each of this run's)."""
    from benchmarks import vm_bench_torch as vb
    from repro_torch.kernels.paged_decode import gather as K67
    from repro_torch.kernels.paged_decode import kernel as K
    K.reset_launch_counts()
    K67.reset_launch_counts()
    _, record = vb.collect(device=dev, base="qwen3-0.6b")
    launches = {**K.LAUNCHES, **K67.LAUNCHES}
    counts = record["kernel_launches"]
    n_attn = attn_layers(full_cfg("float32"))
    for sec in VM_BENCH_SERVING:
        c = counts[sec]
        want = n_attn * c["decode_steps"]
        if not want or c["paged_kv_write"] != want \
                or c["paged_gather_attend"] != want:
            raise AssertionError(f"vm_bench {sec}: {c}")
    sweep, vm = counts["paged_decode"], counts["throughput"]
    if min(sweep.values()) == 0 or min(vm.values()) == 0:
        raise AssertionError(f"vm_bench kernels idle: sweep {sweep}, vm {vm}")
    for name, n in sweep.items():          # a comparison, not the path
        launches[name] -= n
    cpu = vb._load_baseline()
    headlines = {f"{sec}.{key}": {"h100": record[sec][key],
                                  "cpu_bench_tiny": cpu[sec][key]}
                 for sec, key, _ in vb._headline_items()}
    # prefix_index is host work whose query stream is numpy's Zipf
    # sampler: the numpy version stands beside its hit rate
    return launches, {"base": "qwen3-0.6b", "dtype": "float32",
                      "numpy": np.__version__, "headlines": headlines,
                      **record}


# -- phase 16 ------------------------------------------------------------------

#: the reference registry's other decoder archs at their published widths
#: in bf16, each cut in depth (layers run) only where one card's 80 GB
#: cannot hold its weights: qwen2-72b 145 GB, mixtral-8x7b 93 GB,
#: jamba-v0.1-52b 103 GB in full (ModelConfig.param_count, bf16); jamba's
#: 8 layers are one whole period (1 attention + 7 Mamba2, MoE on 4)
ARCHS_LAYERS = {"granite-3-2b": None, "h2o-danube-1.8b": None,
                "qwen2-moe-a2.7b": None, "qwen2-72b": 8, "mixtral-8x7b": 8,
                "jamba-v0.1-52b": 8}
#: the serve phase's trace settings at this many requests, drawn in each
#: arch's vocabulary
ARCHS_REQUESTS = 4
#: the teacher's steps, on pages of 4 slots, so that a sequence's history
#: spans frames of both emulated shards (the oracle's other order)
ARCHS_TEACHER_STEPS, ARCHS_TEACHER_PAGE_SLOTS = 16, 4
#: the archs whose prefill is held to its kernel's plain version: K3 at
#: D 64 on the tensor cores (granite) and D 80 on the CUDA cores (danube),
#: K5 at state 16 (jamba)
ARCHS_PREFILL = {"granite-3-2b": "k3", "h2o-danube-1.8b": "k3",
                 "jamba-v0.1-52b": "k5"}


def arch_cfg(arch: str):
    """``arch`` in bf16 on the serve phase's pooled layout and pool, cut to
    ARCHS_LAYERS[arch] layers where that is set."""
    from repro_torch.configs import get_config
    kw = dict(kv_layout="pooled", kv_page_slots=16, kv_pool_pages=SERVE_POOL,
              param_dtype="bfloat16", compute_dtype="bfloat16")
    if ARCHS_LAYERS[arch]:
        kw["n_layers"] = ARCHS_LAYERS[arch]
    return dataclasses.replace(get_config(arch), **kw)


def check_k3_real(q, k, v, causal, window, err):
    """K3 on one layer's real prefill inputs against ref.mha: each output
    within FLASH_ATOL + FLASH_RTOL times the largest |value| of its (query,
    head) row.  (Real rows mix V rows of magnitudes up to tens whose sum
    can cancel: an element far below its row's scale keeps the f32
    rounding of that scale, which the elementwise phase-6 tolerance, made
    for unit-normal inputs, would not allow.)"""
    from repro_torch.kernels.flash_attention import kernel as K3
    from repro_torch.kernels.flash_attention import ref
    out = K3.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.mha(q, k, v, causal=causal, window=window).float()
    dtype = str(q.dtype).split(".")[1]
    d = (out.float() - want).abs()
    err["k3_real"] = max(err["k3_real"], d.max().item())
    tol = FLASH_ATOL + FLASH_RTOL[dtype] * want.abs().amax(-1, keepdim=True)
    if not bool((d <= tol).all()):
        raise AssertionError(f"K3 on real inputs ({dtype}, q "
                             f"{tuple(q.shape)}) differs from plain by "
                             f"{d.max().item()}")


def k3_real_inputs(model, batch):
    """The inputs K3 is given in one prefill of ``batch`` (copies): one
    ((q, k, v), {"causal", "window"}) per attention layer."""
    from repro_torch.kernels.flash_attention import kernel as K3
    got, launch = [], K3.flash_attention

    def capture(q, k, v, *, causal=True, window=None, scale=None,
                variant=None):
        got.append(((q.clone(), k.clone(), v.clone()),
                    {"causal": causal, "window": window}))
        return launch(q, k, v, causal=causal, window=window, scale=scale,
                      variant=variant)
    K3.flash_attention = capture
    try:
        model.prefill(batch, PREFILL_MAX_LEN)
    finally:
        K3.flash_attention = launch
    return got


def arch_prefill_k3(dev, model):
    """bf16 prefill of 8 prompts of 511 tokens with K3 (attn_impl "pallas")
    and with the plain oracle ("ref") on ``model``'s weights: K3 once per
    attention layer, on the variant ``variant_for`` gives its head dim;
    K3 on the real inputs of every attention layer against ref.mha within
    check_k3_real's tolerance, and on random inputs at the same shape
    within the phase-6 tolerance; logits and K/V cache within LOGIT_RTOL
    (phase prefill's bf16 limit) or, where larger, ORDER_FACTOR times the oracle's own disagreement
    when it sums in another order (``chunked`` attention over 128-key
    chunks): over 40 random-weight layers in bf16 a rounding that flips
    grows to ~0.1 of max |logit| (granite).  Returns (K3 launches of the
    kernel prefill, results)."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as K3
    from repro_torch.kernels.flash_attention import ref
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(model.cfg, kv_layout="batch",
                              attn_impl="pallas")
    m = model.with_config(cfg)
    rng = np.random.default_rng(7)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size,
                                     (PREFILL_B, PREFILL_S)), device=dev)
    m.prefill({"tokens": toks[:, :16]}, PREFILL_MAX_LEN)       # warm up
    torch.cuda.synchronize()
    K3.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = m.prefill({"tokens": toks}, PREFILL_MAX_LEN)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(K3.LAUNCHES)
    n_attn = attn_layers(cfg)
    variant = K3.variant_for(torch.bfloat16, cfg.hd)
    if launches["flash_attention"] != n_attn or launches[
            "flash_attention_tc"] != (n_attn if variant == "tensor_core"
                                      else 0):
        raise AssertionError(f"{cfg.name} prefill: K3 launches {launches} "
                             f"for {n_attn} attention layers ({variant})")
    dev_ms, by_name = device_profile(
        lambda: m.prefill({"tokens": toks}, PREFILL_MAX_LEN), iters=2,
        warmup=0)
    vocab = cfg.vocab_size              # the padded columns hold -1e30

    def values(lg, c):
        return {"logits": lg[:, :vocab], **{
            f"{key}/{name}": t for key, e in c.items()
            for name, t in e.items()}}
    got = values(logits, cache)
    plain = {impl: values(*T.prefill(
        dataclasses.replace(cfg, attn_impl=impl, attn_chunk_q=128,
                            attn_chunk_k=128), m.params, {"tokens": toks},
        PREFILL_MAX_LEN, periods=m.periods()))
        for impl in ("ref", "chunked")}
    rel = {w: rel_err(got[w], plain["ref"][w]) for w in got}
    floor = {w: rel_err(plain["chunked"][w], plain["ref"][w]) for w in got}
    for what, r in rel.items():
        lim = max(LOGIT_RTOL["bfloat16"], ORDER_FACTOR * floor[what])
        if not np.isfinite(r) or r > lim:
            raise AssertionError(f"{cfg.name} prefill {what}: kernel vs "
                                 f"plain {r} of max |value| > {lim} (plain "
                                 f"vs plain {floor[what]})")
    del cache, logits, got, plain
    err = {"k3": 0.0, "k3_real": 0.0}
    real = k3_real_inputs(m, {"tokens": toks})
    for args, kw in real:
        check_k3_real(*args, kw["causal"], kw["window"], err)
    n_real = len(real)
    del real
    q, k, v = fa_case(17, torch.bfloat16, dev, b=PREFILL_B, hq=cfg.n_heads,
                      hkv=cfg.n_kv_heads, sq=PREFILL_S, skv=PREFILL_S,
                      d=cfg.hd)
    check_k3(q, k, v, True, cfg.window, err)
    k3 = timed(lambda: K3.flash_attention(q, k, v, causal=True,
                                          window=cfg.window), iters=10)
    mha = timed(lambda: ref.mha(q, k, v, causal=True, window=cfg.window),
                iters=10)
    del q, k, v
    return launches["flash_attention"], {
        "kernel": "K3", "variant": variant, "head_dim": cfg.hd,
        "shape": [PREFILL_B, cfg.n_heads, cfg.n_kv_heads, PREFILL_S, cfg.hd],
        "k3_launches": launches, "k3_max_abs_err": err["k3"],
        "k3_real_inputs_max_abs_err": err["k3_real"],
        "k3_real_inputs": n_real,
        "k3_ms": k3["device_ms"], "k3_plain_ms": mha["device_ms"],
        "rel": rel, "rel_plain_chunked": floor,
        "rtol": LOGIT_RTOL["bfloat16"], "prefill_ms": wall_ms,
        "device_ms_per_prefill": dev_ms,
        "k3_device_ms_per_prefill": sum(
            v for k, v in by_name.items()
            if any(sym in k for sym in KERNEL_SYMBOLS["flash_attention"]))}


def arch_prefill_k5(dev, model):
    """bf16 prefill of 8 prompts of 512 tokens with K5 and K3 (attn_impl
    "pallas") on ``model``'s weights (jamba: Mamba2 layers at state 16):
    K5 once per Mamba2 layer, on the tensor cores, K3 once per attention
    layer; the logits against the plain path ("ref") within the larger of
    LOGIT_RTOL and SSM_ORDER_FACTOR times the plain path's own half-chunk
    disagreement (as phase ssm_prefill); K5 on the real inputs of every
    Mamba2 layer against ref.ssd_chunked, gated as ssm_k5_real gates them
    with the floors named below (whether bf16 operands alone would fail
    that gate is reported); K5 on random inputs at the same shape within
    SSD_TOL (both variants), and its time.  Returns ({kernel: launches of
    the kernel prefill}, results)."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as K3
    from repro_torch.kernels.mamba2_ssd import kernel as K5
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(model.cfg, kv_layout="batch",
                              attn_impl="pallas")
    m = model.with_config(cfg)
    rng = np.random.default_rng(9)
    batch = {"tokens": torch.tensor(rng.integers(
        0, cfg.vocab_size, (PREFILL_B, PREFILL_MAX_LEN)), device=dev)}
    m.prefill({"tokens": batch["tokens"][:, :16]}, PREFILL_MAX_LEN)
    torch.cuda.synchronize()
    K3.reset_launch_counts()
    K5.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = m.prefill(batch, PREFILL_MAX_LEN)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    n_attn = attn_layers(cfg)
    n_ssm = cfg.n_layers - n_attn
    launches = {**K3.LAUNCHES, **K5.LAUNCHES}
    if launches["ssd"] != n_ssm or launches["ssd_tc"] != n_ssm \
            or launches["flash_attention"] != n_attn:
        raise AssertionError(f"{cfg.name} prefill: launches {launches} for "
                             f"{n_ssm} Mamba2 and {n_attn} attention layers")
    vocab = cfg.vocab_size
    plain = {}
    for chunk in (cfg.ssd_chunk, cfg.ssd_chunk // 2):
        pl, _ = T.prefill(
            dataclasses.replace(cfg, attn_impl="ref", ssd_chunk=chunk),
            m.params, batch, PREFILL_MAX_LEN, periods=m.periods())
        plain[chunk] = pl[:, :vocab]
    rel = rel_err(logits[:, :vocab], plain[cfg.ssd_chunk])
    floor = rel_err(plain[cfg.ssd_chunk // 2], plain[cfg.ssd_chunk])
    lim = max(LOGIT_RTOL["bfloat16"], SSM_ORDER_FACTOR * floor)
    if not np.isfinite(rel) or rel > lim:
        raise AssertionError(f"{cfg.name} prefill logits: kernel vs plain "
                             f"{rel} > {lim} (plain vs plain {floor})")
    del cache, logits, plain
    # K5 within SSD_TOL of its plain version on the reference tests' input
    # distributions at this shape (phase ssd's check), both variants
    err = {"k5": 0.0, "k5_state": 0.0}
    args = ssd_case(23, torch.bfloat16, dev, PREFILL_B, PREFILL_MAX_LEN,
                    cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                    cfg.ssm_groups)
    variant = check_k5(args, cfg.ssd_chunk, err)
    check_k5(args, cfg.ssd_chunk, err, variant="cuda_core")
    # On the real inputs, jamba's scale (weights of std 1: one period is
    # the reference's fan-in; y reaches ~2e9) leaves the decays
    # exp(L_t - L_s) of cumulative sums near 1e6 resolved to a few percent
    # in f32, so any two orders of those sums part on a share of y and of
    # the state: there the tensor-core variant is held to SSM_ORDER_FACTOR
    # times the largest share of the plain version at half the chunk, the
    # plain algebra with its own operand rounding (``ssd_rounded``, split)
    # and the f32 CUDA-core variant (which the check above holds to
    # SSD_TOL)
    k5_real = ssm_k5_real(m, batch, layers=n_ssm, bf16_gate=False,
                          floors=("plain_half_chunk", "split", "cuda_core"))
    k5 = timed(lambda: K5.ssd(*args, chunk=cfg.ssd_chunk))
    nbytes, ops = ssd_work(args, cfg.ssd_chunk)
    del args
    dev_ms, by_name = device_profile(
        lambda: m.prefill(batch, PREFILL_MAX_LEN), iters=2, warmup=0)
    return {"flash_attention": launches["flash_attention"],
            "ssd": launches["ssd"]}, {
        "kernel": "K5", "state": cfg.ssm_state, "heads": cfg.ssm_heads,
        "head_dim": cfg.ssm_head_dim, "chunk": cfg.ssd_chunk,
        "launches": launches, "rel_logits": rel,
        "rel_plain_half_chunk": floor, "limit": lim, "k5_real": k5_real,
        "k5_variant": variant, "k5_max_abs_err": err, "k5_ms": k5["device_ms"],
        "k5_bound_ms": max(nbytes / HBM_BYTES_PER_S,
                           ops / BF16_FLOPS_PER_S) * 1e3,
        "prefill_ms": wall_ms, "device_ms_per_prefill": dev_ms,
        "k5_device_ms_per_prefill": sum(
            v for k, v in by_name.items()
            if any(sym in k for sym in KERNEL_SYMBOLS["ssd"]))}


def phase_arch(dev, arch: str):
    """One arch of ARCHS_LAYERS at its published widths in bf16 on the
    pooled layout (random weights from seed 0): (a) a trace of the serve
    phase's settings at ARCHS_REQUESTS requests through the engine +
    scheduler, every request completed, no frame leaked, K1 and K2 each
    launched once per attention layer and decode step; (b) phase_teacher
    with ``lockstep``: ARCHS_TEACHER_STEPS steps on pages of
    ARCHS_TEACHER_PAGE_SLOTS slots, K1 and K2 held to the composed oracle
    on their real inputs, one step's logits to the oracle's; a profiled
    decode step of 8 sequences; (c) for ARCHS_PREFILL's archs, the prefill
    against its plain version.  Returns ({kernel: launches on the path},
    results)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_decode import kernel as K
    from repro_torch.models.model import Model
    cfg = arch_cfg(arch)
    full = get_config(arch)
    model = Model(cfg, device=dev, seed=0)
    res = {"arch": arch, "reduced": (
        None if cfg.n_layers == full.n_layers else
        {"n_layers": cfg.n_layers, "published_n_layers": full.n_layers})}
    attn_only = attn_layers(cfg) == cfg.n_layers
    engine = {**SERVE_ENGINE, "retain_frames": (
        SERVE_ENGINE["retain_frames"] if attn_only else 0)}
    trace = {**SERVE_TRACE, "n_requests": ARCHS_REQUESTS,
             "vocab_size": cfg.vocab_size}
    K.reset_launch_counts()
    outputs, stats, dt = serve_model(dev, cfg, engine, trace, model=model)
    launches = dict(K.LAUNCHES)
    want = attn_layers(cfg) * stats["decode_steps"]
    for name, n in launches.items():
        if n == 0 or n != want:
            raise AssertionError(f"{arch} {name}: {n} launches for "
                                 f"{stats['decode_steps']} decode steps of "
                                 f"{attn_layers(cfg)} attention layers")
    weight_bytes = cfg.param_count() * 2
    active_bytes = cfg.param_count(active_only=True) * 2
    res.update(
        completed=len(outputs), new_tokens=sum(map(len, outputs.values())),
        decode_steps=stats["decode_steps"], swapped=stats["swapped"],
        attention_layers=attn_layers(cfg), launches=launches, serve_s=dt,
        decode_step_ms=dt / stats["decode_steps"] * 1e3,
        weight_bytes=weight_bytes,
        weight_read_bound_ms=weight_bytes / HBM_BYTES_PER_S * 1e3,
        active_weight_bytes=active_bytes)
    t = time.monotonic()
    res["teacher"] = phase_teacher(
        dev, "bfloat16", steps=ARCHS_TEACHER_STEPS, lockstep=True,
        model=model.with_config(dataclasses.replace(
            cfg, kv_page_slots=ARCHS_TEACHER_PAGE_SLOTS)))
    res["teacher_s"] = time.monotonic() - t
    prof = phase_profile(dev, "pooled", steps=5, model=model.with_config(
        dataclasses.replace(cfg, kv_pool_pages=None)))
    prof.pop("launch_queue_ms")
    res["profile"] = prof
    res["device_ms_per_step"] = (prof["events_device_ms_per_step"]
                                 or prof["device_ms_per_step"])
    t = time.monotonic()
    if ARCHS_PREFILL.get(arch) == "k3":
        launches["flash_attention"], res["prefill"] = arch_prefill_k3(
            dev, model)
    elif ARCHS_PREFILL.get(arch) == "k5":
        more, res["prefill"] = arch_prefill_k5(dev, model)
        launches.update(more)
    res["prefill_s"] = time.monotonic() - t
    del model
    torch.cuda.empty_cache()
    return launches, res


# -- main -----------------------------------------------------------------------

PHASES = ("build,kernels,teacher,profile,serve,tokens,flash,prefill,batch,"
          "ssd,ssm_prefill,ssm_serve,gather,emem,vm,vm_bench,archs")
#: the kernels' libraries, sources and the TPU kernels they replace
KERNELS = (
    ("paged_kv_write", "k1", "src/repro_torch/kernels/paged_decode/csrc/"
     "paged_decode.cu", "src/repro/kernels/paged_decode/kernel.py:107"),
    ("paged_gather_attend", "k2", "src/repro_torch/kernels/paged_decode/csrc/"
     "paged_decode.cu", "src/repro/kernels/paged_decode/kernel.py:211"),
    ("flash_attention", "k3", "src/repro_torch/kernels/flash_attention/csrc/"
     "flash_attention.cu", "src/repro/kernels/flash_attention/kernel.py:84"),
    ("flash_decode", "k4", "src/repro_torch/kernels/paged_decode/csrc/"
     "flash_decode.cu", "src/repro/kernels/paged_decode/flash.py:84"),
    ("ssd", "k5", "src/repro_torch/kernels/mamba2_ssd/csrc/ssd.cu",
     "src/repro/kernels/mamba2_ssd/kernel.py:76"),
    ("gather_pages", "k6", "src/repro_torch/kernels/paged_decode/csrc/"
     "gather.cu", "src/repro/kernels/paged_decode/gather.py:84"),
    ("gather_slots", "k7", "src/repro_torch/kernels/paged_decode/csrc/"
     "gather.cu", "src/repro/kernels/paged_decode/gather.py:46"),
)


def phase_build():
    """nvcc builds every kernel library at once, one process per library."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels.flash_attention import kernel as K3
    from repro_torch.kernels.mamba2_ssd import kernel as K5
    from repro_torch.kernels.paged_decode import flash as K4
    from repro_torch.kernels.paged_decode import gather as K67
    from repro_torch.kernels.paged_decode import kernel as K
    mods = (K, K3, K4, K5, K67)
    with ThreadPoolExecutor(len(mods)) as pool:
        built = list(pool.map(lambda m: m.build(), mods))
    return {m.LIBRARY: {"library": os.path.relpath(path, ROOT),
                        "ptxas": [ln.strip() for ln in log.splitlines()
                                  if "registers" in ln or "spill" in ln]}
            for m, (path, log) in zip(mods, built)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=PHASES,
                    help="comma-separated subset of the phases to run "
                         "(build always runs)")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a checkout",
              file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    launches = {name: 0 for name, *_ in KERNELS}
    err, tm = {}, {}

    def run(phase, fn, *a):
        t = time.monotonic()
        res = fn(*a)
        emit({"phase": phase, "seconds": time.monotonic() - t, **res})

    t = time.monotonic()
    emit({"phase": "build", **phase_build(),
          "seconds": time.monotonic() - t})
    if "kernels" in phases:
        t = time.monotonic()
        e, timing = phase_kernels(dev)
        err.update(e)
        tm.update(timing)
        emit({"phase": "kernels", "seconds": time.monotonic() - t,
              "max_abs_err": e, **timing})
    if "teacher" in phases:
        for dtype in ("float32", "bfloat16"):
            run("teacher", phase_teacher, dev, dtype)
    if "profile" in phases:
        for layout in ("pooled", "batch"):
            run("profile", phase_profile, dev, layout)
    if "serve" in phases:
        t = time.monotonic()
        paged, res = phase_serve(dev)
        launches.update(paged)
        emit({"phase": "serve", "seconds": time.monotonic() - t, **res})
    if "tokens" in phases:
        run("tokens", phase_tokens, dev)
    if "flash" in phases:
        t = time.monotonic()
        e, timing = phase_flash(dev)
        err.update(e)
        tm.update(timing)
        emit({"phase": "flash", "seconds": time.monotonic() - t,
              "max_abs_err": e, **timing})
    if "prefill" in phases:
        for dtype in ("float32", "bfloat16"):
            t = time.monotonic()
            # the bf16 prefill is the path whose K3 launches are reported
            launches["flash_attention"], res = phase_prefill(dev, dtype)
            emit({"phase": "prefill", "seconds": time.monotonic() - t, **res})
    if "batch" in phases:
        t = time.monotonic()
        launches["flash_decode"], res = phase_batch(dev)
        emit({"phase": "batch", "seconds": time.monotonic() - t, **res})
    if "ssd" in phases:
        t = time.monotonic()
        e, timing = phase_ssd(dev)
        err.update(e)
        tm.update(timing)
        emit({"phase": "ssd", "seconds": time.monotonic() - t,
              "max_abs_err": e, **timing})
    if "ssm_prefill" in phases:
        for dtype in ("float32", "bfloat16"):
            t = time.monotonic()
            # the bf16 8 x 512 prefill is the path whose K5 launches are
            # reported
            launches["ssd"], res = phase_ssm_prefill(dev, dtype)
            emit({"phase": "ssm_prefill", "seconds": time.monotonic() - t,
                  **res})
    if "ssm_serve" in phases:
        run("ssm_serve", phase_ssm_serve, dev)
    if "gather" in phases:
        t = time.monotonic()
        e, timing = phase_gather(dev)
        err.update(e)
        tm.update(timing)
        emit({"phase": "gather", "seconds": time.monotonic() - t,
              "max_abs_err": e, **timing})
    if "emem" in phases:
        t = time.monotonic()
        launches["gather_slots"], res = phase_emem(dev)
        emit({"phase": "emem", "seconds": time.monotonic() - t, **res})
    if "vm" in phases:
        t = time.monotonic()
        vm_launches, res = phase_vm(dev)
        launches["gather_slots"] += vm_launches["gather_slots"]
        launches["gather_pages"] = vm_launches["gather_pages"]
        emit({"phase": "vm", "seconds": time.monotonic() - t,
              "launches": vm_launches, **res})
    if "vm_bench" in phases:
        t = time.monotonic()
        bench_launches, res = phase_vm_bench(dev)
        for name, n in bench_launches.items():
            launches[name] += n
        emit({"phase": "vm_bench", "seconds": time.monotonic() - t,
              "launches": bench_launches, **res})
    if "archs" in phases:
        failed = []
        for arch in ARCHS_LAYERS:
            # each arch runs even when one before it failed; the phase
            # fails after the last
            t = time.monotonic()
            try:
                arch_launches, res = phase_arch(dev, arch)
            except AssertionError:
                traceback.print_exc()
                failed.append(arch)
                arch_launches = None
            if arch_launches is None:      # the traceback has let go
                torch.cuda.empty_cache()
                continue
            for name, n in arch_launches.items():
                launches[name] += n
            emit({"phase": "archs", "seconds": time.monotonic() - t, **res})
        if failed:
            raise AssertionError(f"phase archs failed for {failed}")

    def ms(key):
        # the device time of timed(); the event-timed loop where neither
        # device clock read anything
        t = tm.get(key)
        if t is None:
            return None
        return t["device_ms"] if t["device_ms"] is not None else t["loop_ms"]
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[name], "max_abs_err": err.get(key),
         "ms": ms(key), "plain_ms": ms(f"{key}_plain"),
         "bound_ms": tm.get(f"{key}_bound_ms"),
         "bound_by": tm.get(f"{key}_bound_by", "bytes"),
         "library_ms": ms(f"{key}_library")}
        for name, key, src, replaces in KERNELS]})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
