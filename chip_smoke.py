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
then the same memory and the pooled serving path over a process group
(NCCL, world 1, the mesh context installed); then the serving-memory
benchmark (``benchmarks/vm_bench_torch.py``) at
qwen3-0.6b (K1, K2, K6, K7); then the reference's other decoder archs
(granite-3-2b, h2o-danube-1.8b, qwen2-moe-a2.7b, qwen2-72b, mixtral-8x7b,
jamba-v0.1-52b, and qwen2-vl-7b fed frame embeddings) at their published
widths, served through K1 and K2, with K3 and K5 in their prefills; then
the encoder-decoder seamless-m4t-medium (K3 in its encoder and
cross-attention, K1 and K4 in its decoder's self-attention); then
training on the plain paths (qwen3-0.6b and seamless-m4t-medium), on one
card and on a world-1 NCCL mesh; then the paper's analytic models and the
examples built on them; then the dry-run and roofline tooling, held to
measured steps on the card; then tensor-parallel serving (the split form,
``Model.shard``) over two processes on the card.  Each phase prints one
JSON line with its seconds (phase archs one per arch):

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
5. tokens     -- the trace in f32 at CUT_LAYERS's depth gives identical
                 per-uid tokens and telemetry with the kernels and with
                 the composed oracle;
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
8. batch      -- the full-width engine + scheduler at CUT_LAYERS's depth
                 serve the phase-4 trace's first BATCH_REQUESTS requests
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
11. ssm_serve  -- the full-width mamba2-780m engine + scheduler at
                 CUT_LAYERS's depth serve the phase-4 trace's first
                 BATCH_REQUESTS requests on the batch layout in bf16 (its
                 decode is
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
15. mesh      -- an NCCL process group of one rank (a ``file://`` store
                 under build/) and a (1, 1) ("data", "model") DeviceMesh
                 with the mesh context installed: EMem's process-group read
                 and write of the 8 GiB store, 4096 uniform requests with
                 repeated write addresses, bit-equal to the one-card form
                 (K7 once per read), and its exchange driven directly at
                 capacity factor 1 (all_to_all_single through NCCL on the
                 card), bit-equal to the one-shard shortcut; EMemVM on the
                 mesh through phase vm's sequence at 16 cache sets,
                 bit-equal to the one-card EMemVM (K7, K6); phase tokens'
                 trace in f32 at CUT_LAYERS's depth served under the
                 context (the rank body) with the tokens and telemetry of
                 the same trace without it, K1 = K2 = 4 per decode step;
                 one profiled decode step's device ms and ops with and
                 without the context and the collectives a step calls;
                 the group is destroyed at the end;
16. vm_bench  -- benchmarks/vm_bench_torch.py's workloads with the
                 reference's traffic at qwen3-0.6b's full width in f32,
                 at CUT_LAYERS's depth:
                 every reference assertion but the dispatch wall
                 criterion, which is reported, and the sweep's exact m,
                 held to 1e-5; K1 and K2 launched once per
                 layer and decode step in each pooled or reserved
                 section, both in the sweep, K6 and K7 in the EMemVM
                 rows; each headline beside the CPU one of BENCH_vm.json;
17. archs     -- each of ARCHS_LAYERS's six archs in bf16 at its published
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
                 the real inputs of its 7 Mamba2 layers; qwen2-vl-7b's
                 (28 layers, G 7, QKV bias) from frame embeddings through
                 K3 on the tensor cores, and K2 at its G 7 against its
                 plain version with its time (``--archs`` picks a subset);
18. encdec    -- seamless-m4t-medium at its published widths in bf16 on
                 SyntheticLM's frame embeddings (B 8, S_src 512, seed 0):
                 prepare_cross_cache and 64 greedy decode steps launch K3
                 12 + 12 x 64 times (encoder, then cross-attention at
                 Sq 1) and K1 (write off) and K4 12 x 64 times; each step
                 held in lockstep to the plain path within phase archs'
                 gate (bf16 and f32); K3 on every layer's real inputs
                 and at Sq 640 > Skv 512; in f32 the kernel decoder's
                 greedy tokens equal the plain decoder's on one encoder
                 output, K3 on the encoder's real inputs is held to
                 float64, and lm_loss with the kernels equals
                 "chunked"'s; a
                 decode step's device time against its weights' read,
                 K3 at Sq 1 beside SDPA, K4 at D 64 / G 1;
19. train     -- qwen3-0.6b at full width trains 10 steps on the plain
                 paths (bf16 with f32 masters, remat "block", 8 x 512):
                 the loss falls, a run resumed from the step-5
                 checkpoint's files equals the uninterrupted one bit for
                 bit, 2 microbatches match 1; seamless-m4t-medium takes
                 two finite, falling steps; the kernels' grad guard
                 raises for K3 and K5; step ms, tokens/s, the compute
                 bound's share and peak memory;
20. mesh_train -- phase train's qwen3-0.6b for MESH_TRAIN_STEPS steps by
                 the one-card Trainer and by Trainer on a (1, 1) ("data",
                 "model") mesh of an NCCL group of one rank (fsdp_tp, the
                 state as DTensors): losses, grad norms and every weight
                 bit for bit; the mesh's checkpoint restored onto one card
                 bit for bit; step wall and device ms, collectives per
                 step and peak memory of both; the group destroyed;
21. paper     -- benchmarks/figs_torch.py's rows (the reference's Figs.
                 5-13 and §7.3 through repro_torch.core) held to the
                 paper's headline claims, Fig. 10's slowdowns at 4096
                 tiles printed on a line of their own, and the examples
                 emulated_memory_demo_torch and quickstart_torch on the
                 card (quickstart trains on a world-1 NCCL mesh);
22. dryrun    -- the dry-run and roofline tooling (no JAX, no card for
                 the counts): ``launch/dryrun.run_cell`` for qwen3-0.6b,
                 mamba2-780m and mixtral-8x7b over the four shapes on the
                 16 x 16 mesh and qwen3-0.6b train_4k on the 2 x 16 x 16
                 one, each one rank's step counted on meta tensors over a
                 fake group of 256 or 512 ranks, all ok or skipped; the
                 yardstick: qwen3-0.6b's batch-layout decode step (B 8,
                 cache 512) and prefill (8 x 511) counted on a (1, 1)
                 fake mesh and timed on the card (bf16, the kernels'
                 paths), their roofline bounds, device ms and roofline
                 shares, the prefill's counted FLOPs within 5% of the
                 analytic count; benchmarks/run_torch.py's kernel and
                 emem rows (K3-K6 at the reference's bench shapes);
23. tp_serve  -- tensor-parallel serving: K1 + K2 on shards whose query
                 heads lie inside one KV-head group (danube D 80 G 4 with
                 2 and 1 heads, mixtral D 128 G 4 with 2, qwen3 D 128 G 2
                 with 1; f32 and bf16, windows None and 64) against the
                 composed path; then two processes on the one card (gloo,
                 a (1, 2) mesh, tp 2) hold qwen3-0.6b's split form at full
                 width: in f32 a 4-request pooled trace at CUT_LAYERS's
                 depth (K1, K2) serves the one-card engine's tokens, and at
                 full depth the batch layout's prefill (K3) and 8
                 teacher-forced decode steps (K1 with its write off, K4)
                 give one card's logits within 2e-4 of their scale; per-
                 rank weight bytes, collectives per step, a bf16 pooled
                 step's wall and device ms per rank beside one card's;
                 and qwen2-moe-a2.7b's split form (24 layers, f32 from a
                 bf16 draw) with one card's routing gives its logits
                 within the larger of 2e-4 and 4 times one card's own
                 disagreement between its kernels' and plain attention.

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
#: the trace's requests on the batch layout (phases batch, ssm_serve),
#: where nothing swaps or shares: fewer, so that the script's host-bound
#: serving fits its time; phase tokens' two f32 runs serve all 16 and swap
BATCH_REQUESTS = 8
TOKENS_REQUESTS = SERVE_TRACE["n_requests"]
#: the depth of the serving checks that repeat the main path's work on
#: other paths (phases tokens, batch and vm_bench at qwen3-0.6b, 28
#: published layers; phase ssm_serve at mamba2-780m, 48): their engines
#: launch every layer's ops from Python, so a step's wall time grows with
#: the depth while the kernels' shapes stay the full width's.  Phases
#: teacher, profile and serve keep the published depth.
CUT_LAYERS = {"qwen3-0.6b": 4, "mamba2-780m": 8}


def reduced(arch: str) -> dict:
    """The ``reduced`` entry of a phase run at CUT_LAYERS[arch] layers."""
    from repro_torch.configs import get_config
    return {"n_layers": CUT_LAYERS[arch],
            "published_n_layers": get_config(arch).n_layers}


#: a file that every emitted line is also appended to (``--log``)
LOG_PATH = None


def emit(obj: dict) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    if LOG_PATH:
        with open(LOG_PATH, "a") as f:
            f.write(line + "\n")


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
    "record" each ``moe._route`` call keeps its top-k ids and weights;
    while it is "replay" each call takes the recorded ids of the same call
    in order (its weights renormalised from its own probabilities at those
    ids), and while it is "replay_weights" the recorded weights too; both
    count the tokens whose own choice differed (``flips``).  Otherwise the
    routing is untouched.  "record" also keeps the largest |router score|
    (``score_max``, on the device until read)."""

    def __init__(self):
        self.mode, self.ids, self.weights, self.at = None, [], [], 0
        self.flips = self.routed = 0
        self.score_max = None

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
            self.ids, self.weights = [], []

    def _route(self, cfg, p, xt):
        probs, weights, idx = self.route(cfg, p, xt)
        if self.mode == "record":
            self.ids.append(idx)
            self.weights.append(weights)
            top = (xt @ p["router"]).float().abs().amax()
            self.score_max = top if self.score_max is None else \
                self.score_max.maximum(top)
        elif self.mode in ("replay", "replay_weights"):
            pinned = self.ids[self.at]
            own = idx.sort(-1).values != pinned.sort(-1).values
            self.flips += int(own.any(-1).sum().item())
            self.routed += idx.shape[0]
            if self.mode == "replay":
                weights = probs.gather(1, pinned)
                weights = weights / weights.sum(-1, keepdim=True)
            else:
                weights = self.weights[self.at]
            idx = pinned
            self.at += 1
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

def serve(dev, dtype: str, n_requests=None, **cfg_kw):
    """Replay the trace (cut to ``n_requests`` where given) through the
    full-width qwen3-0.6b engine (pooled layout unless ``cfg_kw`` says
    otherwise); returns (per-uid outputs, shutdown stats, seconds)."""
    cfg = full_cfg(dtype, **{"kv_pool_pages": SERVE_POOL, **cfg_kw})
    trace = dict(SERVE_TRACE, n_requests=n_requests or SERVE_TRACE[
        "n_requests"])
    return serve_model(dev, cfg, SERVE_ENGINE, trace)


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
    cut = CUT_LAYERS["qwen3-0.6b"]
    kern, st_k, dt_k = serve(dev, "float32", TOKENS_REQUESTS,
                             paged_kernel="auto", n_layers=cut)
    comp, st_c, dt_c = serve(dev, "float32", TOKENS_REQUESTS,
                             paged_kernel="composed", n_layers=cut)
    if kern != comp:
        bad = sorted(u for u in kern if kern[u] != comp.get(u))
        raise AssertionError(f"f32 served tokens differ, kernels vs composed, "
                             f"for uids {bad}")
    if st_k["telemetry"] != st_c["telemetry"]:
        raise AssertionError("f32 telemetry differs, kernels vs composed")
    return {"reduced": reduced("qwen3-0.6b"), "requests": len(kern),
            "new_tokens": sum(len(o) for o in kern.values()),
            "swapped": st_k["swapped"],
            "shared_prompt_tokens": st_k["shared_prompt_tokens"],
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
    """The phase-4 trace's first BATCH_REQUESTS requests on the batch KV
    layout at CUT_LAYERS's depth: bf16 with the kernels (every
    decode step of every layer launches K1 with its page write off, for the
    q/k norm and rotary, and K4; K2 and K3 never run), then f32 with the
    kernels and with the plain path (attn_impl "ref"), whose per-uid tokens
    and telemetry must be identical."""
    from repro_torch.kernels.flash_attention import kernel as K3
    from repro_torch.kernels.paged_decode import flash as K4
    from repro_torch.kernels.paged_decode import kernel as K
    batch = dict(kv_layout="batch", n_layers=CUT_LAYERS["qwen3-0.6b"])
    for mod in (K, K3, K4):
        mod.reset_launch_counts()
    outputs, stats, dt = serve(dev, "bfloat16", BATCH_REQUESTS,
                               attn_impl="pallas", **batch)
    launches = K4.LAUNCHES["flash_decode"]
    k1 = K.LAUNCHES["paged_kv_write"]
    others = {"paged_gather_attend": K.LAUNCHES["paged_gather_attend"],
              **K3.LAUNCHES}
    n_attn = attn_layers(full_cfg("bfloat16", **batch))
    for name, n in (("flash_decode", launches), ("paged_kv_write", k1)):
        if n == 0 or n != n_attn * stats["decode_steps"]:
            raise AssertionError(f"{name}: {n} launches for "
                                 f"{stats['decode_steps']} decode steps")
    if any(others.values()):
        raise AssertionError(f"batch serving launched other kernels: {others}")
    kern, st_k, dt_k = serve(dev, "float32", BATCH_REQUESTS,
                             attn_impl="pallas", **batch)
    plain, st_p, dt_p = serve(dev, "float32", BATCH_REQUESTS,
                              attn_impl="ref", **batch)
    if kern != plain:
        bad = sorted(u for u in kern if kern[u] != plain.get(u))
        raise AssertionError(f"f32 batch-layout tokens differ, kernels vs "
                             f"plain, for uids {bad}")
    if st_k["telemetry"] != st_p["telemetry"]:
        raise AssertionError("f32 batch-layout telemetry differs")
    new_tokens = sum(len(o) for o in outputs.values())
    return launches, {
        "reduced": reduced("qwen3-0.6b"),
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
#: f32 fused against stepwise: the trace cut to its first requests
SSM_TOKENS_REQUESTS = 4


def phase_ssm_serve(dev):
    """The phase-4 trace's first BATCH_REQUESTS requests through the
    full-width mamba2-780m engine, cut to CUT_LAYERS's depth, on the batch
    layout in bf16: every request completes and no kernel launches
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
    cut = CUT_LAYERS["mamba2-780m"]
    cfg = mamba_cfg("bfloat16", attn_impl="pallas", n_layers=cut)
    trace = dict(SERVE_TRACE, vocab_size=cfg.vocab_size,
                 n_requests=BATCH_REQUESTS)
    outputs, stats, dt = serve_model(dev, cfg, SSM_SERVE_ENGINE, trace)
    launched = {k: n for mod in mods for k, n in mod.LAUNCHES.items() if n}
    if launched:
        raise AssertionError(f"SSM serving launched kernels: {launched}")
    new_tokens = sum(len(o) for o in outputs.values())
    res = {"reduced": reduced("mamba2-780m"),
           "completed": len(outputs), "new_tokens": new_tokens,
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
    f32 = mamba_cfg("float32", attn_impl="pallas", n_layers=cut)
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
            and torch.equal(a.contiguous().reshape(-1).view(torch.uint8),
                            b.contiguous().reshape(-1).view(torch.uint8)))


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

#: phase mesh's EMemVM run: phase vm's sequence at one of its cache sizes
MESH_VM_SETS = 16
#: decode steps profiled with and without the mesh context
MESH_PROFILE_STEPS = 5


def mesh_step(dev, model, iters: int = MESH_PROFILE_STEPS):
    """One pooled decode step of 8 sequences at 256 tokens over scrambled
    tables (phase profile's inputs) on ``model``, under whatever mesh
    context is installed: wall ms and device ms and device ops per step
    (torch.profiler), each over ``iters`` steps, and the collectives one
    step calls."""
    import torch
    from repro_torch.parallel import mesh_ctx
    from repro_torch.serve.fused_decode import sampled_decode_step
    cache = model.init_cache(B, MAX_LP * PS)
    rng = np.random.default_rng(5)
    bt, fl, fr = mk_vm(rng, B, MAX_LP, PS, [MAX_LP * PS] * B, False)
    cache["vm"] = {"block_table": torch.tensor(bt, device=dev),
                   "frame_lpage": torch.tensor(fl, device=dev),
                   "frame_ro": torch.tensor(fr, device=dev)}
    wm = torch.ones(B, dtype=torch.bool, device=dev)
    tok = torch.tensor(rng.integers(0, model.cfg.vocab_size, (B, 1)),
                       dtype=torch.int32, device=dev)
    lengths = torch.full((B,), 256, dtype=torch.int32, device=dev)

    def step():
        sampled_decode_step(model, tok, cache, lengths, wm)
    step()
    mesh_ctx.reset_calls()
    step()
    calls = dict(mesh_ctx.CALLS)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) / iters * 1e3
    ms, by_name = device_profile(step, iters=iters)
    if ms is None:
        raise AssertionError("the profiler saw no device time in a step")
    nccl = {k[:60]: v for k, v in by_name.items() if "nccl" in k.lower()}
    del cache
    return {"wall_ms": wall, "device_ms": ms,
            "device_ops": by_name["device_ops_per_call"],
            "collectives": calls, "nccl_kernels_ms": nccl}


def collective_us(dev, group, iters: int = 200):
    """Host us per call of each collective the port makes, on the
    shapes of a served step's (a [8, 8, 128] f32 block; the all_to_all on
    [1, 4096] int32), queued without a sync, then the device time per
    call on the CUDA-event clock."""
    import torch
    from repro_torch.parallel import mesh_ctx
    x = torch.ones((8, 8, 128), device=dev)
    a = torch.zeros((1, 4096), dtype=torch.int32, device=dev)
    calls = {"all_reduce": lambda: mesh_ctx.all_reduce(x, "sum", group),
             "all_gather": lambda: mesh_ctx.all_gather(x, group),
             "all_to_all": lambda: mesh_ctx.all_to_all(a, group)}
    out = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        host = (time.perf_counter() - t) / iters * 1e6
        torch.cuda.synchronize()
        out[name] = {"host_us": host,
                     "event_us": cuda_ms(fn, iters=iters) * 1e3}
    return out


def phase_mesh(dev):
    """The port over a process group on the card, at world 1: NCCL, a
    ``(1, 1)`` ("data", "model") DeviceMesh, the mesh context installed.
    EMem's process-group read and write of the 8 GiB store at one shard,
    4096 uniform requests with repeated write addresses, bit-equal to the
    one-card form (K7 once per read), and its exchange driven directly at
    capacity factor 1, where it cannot drop, through ``all_to_all_single``
    on the card, bit-equal to the shortcut; EMemVM on the mesh through
    phase vm's sequence (K7, K6 on fills and swap-outs) bit-equal to the
    one-card EMemVM; phase tokens' trace at CUT_LAYERS's depth in f32
    served under the context with the tokens and telemetry of the same
    trace without it, K1 = K2 = attention layers per decode step; one
    profiled decode step with and without the context and the collectives
    it calls.  The group is destroyed at the end.  Returns ({kernel:
    launches}, results)."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import emem
    from repro_torch.emem_vm import EMemVM, VMConfig
    from repro_torch.kernels.paged_decode import gather as K67
    from repro_torch.kernels.paged_decode import kernel as K
    from repro_torch.launch.mesh import init_process_group, make_host_mesh
    from repro_torch.models.model import Model
    from repro_torch.parallel import mesh_ctx
    cut = CUT_LAYERS["qwen3-0.6b"]
    launches = {"paged_kv_write": 0, "paged_gather_attend": 0,
                "gather_pages": 0, "gather_slots": 0}
    res = {"reduced": reduced("qwen3-0.6b")}
    plain, st_plain, res["plain_serve_s"] = serve(
        dev, "float32", TOKENS_REQUESTS, n_layers=cut)
    model = Model(full_cfg("float32", n_layers=cut), device=dev, seed=0)
    res["step_plain"] = mesh_step(dev, model)
    store = os.path.join(ROOT, "build", f"mesh_store_{os.getpid()}")
    os.makedirs(os.path.dirname(store), exist_ok=True)
    if os.path.exists(store):
        os.remove(store)
    t = time.monotonic()
    res["backend"] = init_process_group(dev, rank=0, world_size=1,
                                        init_method=f"file://{store}")
    try:
        mesh = make_host_mesh(device=dev)
        ctx = mesh_ctx.set_context(mesh)
        group = ctx.kv_group
        if res["backend"] != "nccl" or dist.get_backend(group) != "nccl":
            raise AssertionError(f"backend {dist.get_backend(group)}")
        res["group_start_s"] = time.monotonic() - t
        res["collective_us"] = collective_us(dev, group)
        # EMem: the rank's block is the whole store at one shard
        spec = emem.EMemSpec(**EMEM_SPEC)
        data = emem_store(dev, 103)
        twin = data.clone()
        g = torch.Generator(device=dev).manual_seed(131)
        addrs, vals, _ = emem_batch(dev, spec, g, EMEM_CF)
        vals2 = torch.randn_like(vals)
        K67.reset_launch_counts()
        got = [emem.read(spec, data, addrs, EMEM_CF, group=group)]
        emem.write(spec, data, addrs, vals, EMEM_CF, group=group)
        got.append(emem.read(spec, data, addrs, EMEM_CF, group=group))
        torch.cuda.synchronize()
        if K67.LAUNCHES != {"gather_slots": 2, "gather_pages": 0}:
            raise AssertionError(f"EMem on the group launched {K67.LAUNCHES}")
        launches["gather_slots"] += 2
        want = [emem.read(spec, twin, addrs, EMEM_CF)]
        emem.write(spec, twin, addrs, vals, EMEM_CF)
        want.append(emem.read(spec, twin, addrs, EMEM_CF))
        if not all(map(same_bits, got, want)) or not same_bits(data, twin):
            raise AssertionError("EMem on the group differs from one card")
        # the exchange at factor 1 (no drop): all_to_all_single through NCCL
        cap = emem.capacity_for(spec, addrs.numel(), 1.0)
        mesh_ctx.reset_calls()
        ex = emem.read_exchange(spec, group, data, addrs, cap)
        emem.write_exchange(spec, group, data, addrs, vals2, cap)
        torch.cuda.synchronize()
        res["exchange_calls"] = dict(mesh_ctx.CALLS)
        emem.write(spec, twin, addrs, vals2, 1.0)
        if mesh_ctx.CALLS["all_to_all"] != 4 or not same_bits(ex, want[1]) \
                or not same_bits(data, twin):
            raise AssertionError("EMem's exchange differs from the shortcut")
        res["emem"] = {"requests": addrs.numel(), "capacity": cap,
                       "read_us": wall_us(lambda: emem.read(
                           spec, data, addrs, EMEM_CF, group=group)),
                       "exchange_read_us": wall_us(lambda: emem.read_exchange(
                           spec, group, data, addrs, cap))}
        del data, twin, ex, got, want
        torch.cuda.empty_cache()
        # EMemVM on the mesh against the one-card EMemVM
        cfg = VMConfig(spec=spec, n_vpages=2 * spec.n_pages,
                       cache_sets=MESH_VM_SETS, n_host_pages=VM_HOST_PAGES)
        vm = EMemVM(cfg, device=dev, mesh=mesh, axes=("data",))
        kern = vm_run(vm, 113, check_launches=True)
        for k, n in kern[5].items():
            launches[k] += n
        one = EMemVM(cfg, sharded=True, device=dev)
        ref = vm_run(one, 113, check_launches=False)
        if not all(map(same_bits, kern[0], ref[0])) or kern[1:3] != ref[1:3] \
                or not same_bits(vm.data, one.data):
            raise AssertionError("EMemVM on the mesh differs from one card")
        res["vm"] = {"vreads": len(kern[0]), "vread_us": kern[3],
                     "vwrite_us": kern[4], "one_card_vread_us": ref[3],
                     "one_card_vwrite_us": ref[4], "launches": kern[5],
                     "faults": kern[1]["faults"],
                     "swap_outs": kern[1]["swap_outs"]}
        del vm, one, kern, ref
        torch.cuda.empty_cache()
        # the trace under the context: the rank body at world 1
        K.reset_launch_counts()
        mesh_ctx.reset_calls()
        outputs, stats, res["mesh_serve_s"] = serve(
            dev, "float32", TOKENS_REQUESTS, n_layers=cut)
        serve_calls = dict(mesh_ctx.CALLS)
        steps = stats["decode_steps"]
        n_attn = attn_layers(full_cfg("float32", n_layers=cut))
        for name, n in K.LAUNCHES.items():
            if n != n_attn * steps:
                raise AssertionError(f"{name}: {n} launches for {steps} "
                                     "decode steps under the context")
            launches[name] += n
        if outputs != plain:
            bad = sorted(u for u in plain if plain[u] != outputs.get(u))
            raise AssertionError(f"tokens differ under the context for {bad}")
        if stats["telemetry"] != st_plain["telemetry"] \
                or steps != st_plain["decode_steps"]:
            raise AssertionError("telemetry differs under the context")
        res["serve"] = {"requests": len(outputs), "decode_steps": steps,
                        "swapped": stats["swapped"],
                        "shared_prompt_tokens": stats["shared_prompt_tokens"],
                        "collectives": serve_calls,
                        "collectives_per_step": sum(serve_calls.values())
                        / steps}
        res["step_mesh"] = mesh_step(dev, model)
    finally:
        mesh_ctx.clear_context()
        dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)
    if dist.is_initialized():
        raise AssertionError("the process group outlived phase mesh")
    del model
    torch.cuda.empty_cache()
    return launches, res


# -- phase 16 ------------------------------------------------------------------

#: the sections whose engines serve through K1 and K2 (the pooled and
#: reserved layouts); ``paged_decode`` is the sweep, ``throughput`` EMemVM
VM_BENCH_SERVING = ("prefix_sharing", "swap", "tiered", "retention",
                    "scheduling", "slo", "dispatch")


def phase_vm_bench(dev):
    """benchmarks/vm_bench_torch.py at qwen3-0.6b's full width in f32, cut
    to CUT_LAYERS's depth: the reference's serving workloads with their traffic unchanged, every
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
    cut = CUT_LAYERS["qwen3-0.6b"]
    _, record = vb.collect(device=dev, base="qwen3-0.6b", n_layers=cut)
    launches = {**K.LAUNCHES, **K67.LAUNCHES}
    counts = record["kernel_launches"]
    n_attn = attn_layers(full_cfg("float32", n_layers=cut))
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
    return launches, {"base": "qwen3-0.6b", "reduced": reduced("qwen3-0.6b"),
                      "dtype": "float32",
                      "numpy": np.__version__, "headlines": headlines,
                      **record}


# -- phase 17 ------------------------------------------------------------------

#: the reference registry's other decoder archs at their published widths
#: in bf16, each cut in depth (layers run) only where one card's 80 GB
#: cannot hold its weights: qwen2-72b 145 GB, mixtral-8x7b 93 GB,
#: jamba-v0.1-52b 103 GB in full (ModelConfig.param_count, bf16); jamba's
#: 8 layers are one whole period (1 attention + 7 Mamba2, MoE on 4);
#: qwen2-vl-7b (15.2 GB) at full depth, its vision frontend a stub fed
#: frame embeddings
ARCHS_LAYERS = {"granite-3-2b": None, "h2o-danube-1.8b": None,
                "qwen2-moe-a2.7b": None, "qwen2-72b": 8, "mixtral-8x7b": 8,
                "jamba-v0.1-52b": 8, "qwen2-vl-7b": None}
#: the serve phase's trace settings at this many requests, drawn in each
#: arch's vocabulary
ARCHS_REQUESTS = 4
#: the teacher's steps, on pages of 4 slots, so that a sequence's history
#: spans frames of both emulated shards (the oracle's other order)
ARCHS_TEACHER_STEPS, ARCHS_TEACHER_PAGE_SLOTS = 16, 4
#: the archs whose prefill is held to its kernel's plain version: K3 at
#: D 64 on the tensor cores (granite), D 80 on the CUDA cores (danube) and
#: D 128 at G 7 on the tensor cores from frame embeddings (qwen2-vl), K5
#: at state 16 (jamba)
ARCHS_PREFILL = {"granite-3-2b": "k3", "h2o-danube-1.8b": "k3",
                 "jamba-v0.1-52b": "k5", "qwen2-vl-7b": "k3"}
#: the archs whose K2 is timed at their own decode shape (G 7)
ARCHS_K2_TIMED = ("qwen2-vl-7b",)


def k2_timing(dev, cfg, err, copies=8):
    """K2 at ``cfg``'s decode shape in bf16 (its KV heads, head group and
    head dim; B 8 sequences of ragged lengths up to MAX_LP * PS over
    scrambled tables of 16-slot pages, the page pool cycled over
    ``copies`` sets, 8 x 17 MB at qwen2-vl's widths): (acc, m, l) held to
    its plain version (ref.attend_shard) as PagedStepProbe holds them,
    then its time beside the plain version's and the bytes bound (each
    attended K/V row read once, q and the table entries read, (acc, m, l)
    written)."""
    import torch
    from repro_torch.kernels.paged_decode import kernel as K
    from repro_torch.kernels.paged_decode import ref
    hkv, g, d = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd
    rng = np.random.default_rng(91)
    lengths = rng.integers(1, MAX_LP * PS + 1, B).astype(np.int32)
    bt, fl, _ = mk_vm(rng, B, MAX_LP, PS, lengths, False)

    def t(*shape):
        return torch.tensor(rng.normal(size=shape).astype(np.float32),
                            device=dev).to(torch.bfloat16)
    pools = [(t(B * MAX_LP, PS, hkv, d), t(B * MAX_LP, PS, hkv, d))
             for _ in range(copies)]
    q = t(B, hkv * g, d)
    qg = q.reshape(B, hkv, g, d)
    btt, flt, lt = (torch.tensor(a, device=dev) for a in (bt, fl, lengths))
    it = itertools.count()

    def k2():
        p = pools[next(it) % copies]
        return K.paged_gather_attend(qg, p[0], p[1], btt, lt, (0, 1, 0))

    def plain():
        p = pools[next(it) % copies]
        return ref.attend_shard(q, p[0], p[1], lt, btt, flt, sid=0,
                                n_shards=1, head_start=0, group=g,
                                window=None, max_pages=MAX_LP)
    it = itertools.count()
    got = k2()
    it = itertools.count()
    want = plain()
    m = want[1].reshape(B, hkv, g, 1)
    cond = max(1.0, m.abs().max().item())
    acc = want[0].reshape(B, hkv, g, d)
    for name, a, w, tol in (
            ("acc", got[0], acc, (K2_ATOL + K2_RTOL * acc.abs().amax(
                -1, keepdim=True)) * cond),
            ("m", got[1], m, M_ATOL + K2_RTOL * cond),
            ("l", got[2], want[2].reshape(B, hkv, g, 1),
             (K2_ATOL + K2_RTOL * want[2].reshape(B, hkv, g, 1).abs())
             * cond)):
        dlt = (a - w).abs()
        err[f"k2_{name}"] = max(err.get(f"k2_{name}", 0.0), dlt.max().item())
        if not bool((dlt <= tol).all()):
            raise AssertionError(f"K2 {name} at G {g}, D {d}: max |diff| "
                                 f"{dlt.max().item()}")
    k2_t, plain_t = timed(k2), timed(plain, iters=20)
    attended = int(lengths.sum())
    entries = int(sum(-(-int(n) // PS) for n in lengths))
    nbytes = (2 * attended * hkv * d * 2 + B * hkv * g * d * 2 + 4 * entries
              + 4 * B + B * hkv * g * (d + 2) * 4)
    ops = 4 * g * d * hkv * attended
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S
    return {"shape": [B, hkv, g, MAX_LP * PS, d], "ms": k2_t["device_ms"],
            "plain_ms": plain_t["device_ms"],
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


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


def arch_prefill_k3(dev, model):
    """bf16 prefill of 8 prompts of 511 tokens (of frame embeddings where
    the arch has a frontend stub) with K3 (attn_impl "pallas")
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
    if cfg.frontend is not None:
        # the stub's input: frame embeddings in place of tokens
        batch = {"embeds": torch.tensor(rng.standard_normal(
            (PREFILL_B, PREFILL_S, cfg.d_model), dtype=np.float32),
            device=dev).to(torch.bfloat16)}
    else:
        batch = {"tokens": torch.tensor(rng.integers(
            0, cfg.vocab_size, (PREFILL_B, PREFILL_S)), device=dev)}
    m.prefill({k: v[:, :16] for k, v in batch.items()},
              PREFILL_MAX_LEN)                                 # warm up
    torch.cuda.synchronize()
    K3.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = m.prefill(batch, PREFILL_MAX_LEN)
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
        lambda: m.prefill(batch, PREFILL_MAX_LEN), iters=2, warmup=0)
    vocab = cfg.vocab_size              # the padded columns hold -1e30

    def values(lg, c):
        return {"logits": lg[:, :vocab], **{
            f"{key}/{name}": t for key, e in c.items()
            for name, t in e.items()}}
    got = values(logits, cache)
    plain = {impl: values(*T.prefill(
        dataclasses.replace(cfg, attn_impl=impl, attn_chunk_q=128,
                            attn_chunk_k=128), m.params, batch, PREFILL_MAX_LEN,
        periods=m.periods()))
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
    real = k3_inputs(lambda: m.prefill(batch, PREFILL_MAX_LEN))
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
        "input": sorted(batch),
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
    if arch in ARCHS_K2_TIMED:
        res["k2_timing"] = k2_timing(dev, cfg, res.setdefault("k2_err", {}))
    del model
    torch.cuda.empty_cache()
    return launches, res


# -- phase 18 ------------------------------------------------------------------

#: phase encdec: seamless-m4t-medium at its published widths serving B 8
#: sequences of S_src 512 frame embeddings (SyntheticLM's first batch at
#: seed 0), 64 greedy decode steps from token 0 each
ENCDEC_B, ENCDEC_SRC, ENCDEC_STEPS = 8, 512, 64
#: K3 beyond the path: non-causal queries longer than the source (the
#: teacher-forced decoder of a target longer than its source)
ENCDEC_LONG_Q = 640


def encdec_cfg(dtype: str, **kw):
    """seamless-m4t-medium in ``dtype`` with the kernels (attn_impl
    "pallas") unless ``kw`` says otherwise."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("seamless-m4t-medium"),
                               **{"param_dtype": dtype, "compute_dtype": dtype,
                                  "attn_impl": "pallas", **kw})


def encdec_batch(cfg, dev):
    """SyntheticLM(ENCDEC_B x ENCDEC_SRC, seed 0)'s first batch on ``dev``:
    frame embeddings in the compute dtype, tokens, labels and mask."""
    import torch
    from repro_torch.data import DataConfig, SyntheticLM
    batch = SyntheticLM(cfg, DataConfig(ENCDEC_B, ENCDEC_SRC,
                                        seed=0)).global_batch(0)
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


class ReversedDecodeDots:
    """While entered, the batch-layout decode attention's plain version
    (``flash_ref.decode_attention``) sums each q.k over the head dim in
    reverse order: the same arithmetic in another order."""

    def __enter__(self):
        from repro_torch.kernels.paged_decode import flash_ref
        self.mod, self.fn = flash_ref, flash_ref.decode_attention

        def reversed_dots(q, k, v, lengths, **kw):
            rev = self.rev(q)
            return self.fn(q[..., rev], k[..., rev], v, lengths, **kw)
        flash_ref.decode_attention = reversed_dots
        return self

    @staticmethod
    def rev(q):
        import torch
        return torch.arange(q.shape[-1] - 1, -1, -1, device=q.device)

    def __exit__(self, *exc):
        self.mod.decode_attention = self.fn


def encdec_decode(model, embeds, steps, oracle=None, reordered=None,
                  cross=None, top2=None):
    """prepare_cross_cache, then ``steps`` greedy decode steps from token 0
    (each step feeds back its argmax).  With ``oracle`` and ``reordered``
    (the plain path, and the plain path summed in another order: run under
    ReversedDecodeDots), each step also runs on those models from a copy
    of the decode's self-attention cache as it stood before the step, on
    the same token.  Returns (tokens [steps, B] on the host, {"oracle":
    max |logit diff| of the decode against the oracle, "reordered": of the
    reordered oracle against the oracle, and "oracle_argmax" /
    "reordered_argmax": the (step, sequence) pairs whose argmax differs
    from the oracle's}, max |logit| of the oracle).  ``cross`` gives the
    cross-attention K/V (``xk``, ``xv``) in place of the model's own
    encoder's; ``top2`` (a list) collects each step's two largest logits
    per sequence [B, 2] on the host."""
    import torch
    b, dev = embeds.shape[0], embeds.device
    vocab = model.cfg.vocab_size
    cache = model.init_cache(b, steps, src_len=embeds.shape[1])
    cache = (dict(cache, **cross) if cross is not None
             else model.prepare_cross_cache(embeds, cache))
    tok = torch.zeros((b, 1), dtype=torch.int32, device=dev)
    toks, scale = [], 0.0
    diff = {"oracle": 0.0, "reordered": 0.0, "oracle_argmax": 0,
            "reordered_argmax": 0}
    for i in range(steps):
        lengths = torch.full((b,), i + 1, dtype=torch.int32, device=dev)
        copies = [dict(cache, k=cache["k"].clone(), v=cache["v"].clone())
                  for _ in (oracle, reordered) if oracle is not None]
        logits, cache = model.decode_step(tok, cache, lengths)
        logits = logits[:, :vocab]
        if oracle is not None:
            want = oracle.decode_step(tok, copies[0], lengths)[0][:, :vocab]
            with ReversedDecodeDots():
                other = reordered.decode_step(tok, copies[1],
                                              lengths)[0][:, :vocab]
            scale = max(scale, want.abs().max().item())
            top = want.argmax(-1)
            for name, got in (("oracle", logits), ("reordered", other)):
                diff[name] = max(diff[name], (got - want).abs().max().item())
                diff[f"{name}_argmax"] += int((got.argmax(-1) != top).sum())
        if top2 is not None:
            top2.append(logits.topk(2, -1).values.cpu())
        tok = logits.argmax(-1, keepdim=True).to(torch.int32)
        toks.append(tok[:, 0])
    return torch.stack(toks).cpu(), diff, scale


def k3_f64_errors(q, k, v, causal, window) -> dict:
    """K3 and its plain version (ref.mha) on one input set, each
    against the same attention in float64: the largest |error| of each,
    the largest |scaled logit| (whose f32 rounding exp() turns into a
    relative error of p), and ``ok``: K3 within the larger of phase 6's
    tolerance at the output's scale and ORDER_FACTOR times the plain
    version's own error."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as K3
    from repro_torch.kernels.flash_attention import ref
    b, hq, sq, d = q.shape
    g = hq // k.shape[1]
    q64 = q.double().reshape(b, k.shape[1], g, sq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", q64, k.double()) * d ** -0.5
    s = s.masked_fill(~ref.attention_mask(sq, k.shape[2], causal=causal,
                                          window=window, device=q.device),
                      -1e300)
    want = torch.einsum("bhgqk,bhkd->bhgqd", torch.softmax(s, -1),
                        v.double()).reshape(b, hq, sq, d)
    got = K3.flash_attention(q, k, v, causal=causal, window=window)
    plain = ref.mha(q, k, v, causal=causal, window=window)
    e_k3 = (got.double() - want).abs().max().item()
    e_plain = (plain.double() - want).abs().max().item()
    lim = max(FLASH_ATOL + FLASH_RTOL["float32"] * want.abs().max().item(),
              ORDER_FACTOR * e_plain)
    return {"k3": e_k3, "plain": e_plain, "limit": lim,
            "max_abs_logit": s.masked_fill(s < -1e299, 0).abs().max().item(),
            "ok": e_k3 <= lim}


def first_divergence(a, b) -> list:
    """Per sequence, the first step whose token differs between the token
    runs ``a`` and ``b`` [steps, B], or None."""
    import torch
    out = []
    for j in range(a.shape[1]):
        bad = (a[:, j] != b[:, j]).nonzero()
        out.append(int(bad[0]) if len(bad) else None)
    return out


def encdec_lockstep(model, embeds, dtype: str) -> dict:
    """The lockstep gate of phase archs for ``model`` (the kernels): each of
    ENCDEC_STEPS steps against the plain path (attn_impl "ref") and the
    plain path summed in another order (the cross-attention over 128-key
    chunks, the self-attention's q.k in reverse) from the kernel decode's
    cache before the step; the kernels' logits within the larger of
    LOGIT_RTOL[dtype] and ORDER_FACTOR times the plain path's own
    disagreement.  Returns the readings, with ``ok``."""
    cfg = model.cfg
    oracle = model.with_config(dataclasses.replace(cfg, attn_impl="ref"))
    reordered = model.with_config(dataclasses.replace(
        cfg, attn_impl="chunked", attn_chunk_q=128, attn_chunk_k=128))
    _, diff, scale = encdec_decode(model, embeds, ENCDEC_STEPS, oracle,
                                   reordered)
    rel = {k: diff[k] / scale for k in ("oracle", "reordered")}
    lim = max(LOGIT_RTOL[dtype], ORDER_FACTOR * rel["reordered"])
    return {"rel": rel["oracle"], "limit": lim,
            "reordered_rel": rel["reordered"], "max_abs_logit": scale,
            "argmax_differ": diff["oracle_argmax"],
            "reordered_argmax_differ": diff["reordered_argmax"],
            "of": ENCDEC_STEPS * embeds.shape[0],
            "ok": bool(np.isfinite(rel["oracle"]) and rel["oracle"] <= lim)}


def k3_inputs(fn):
    """The inputs K3 is given while ``fn()`` runs (copies): one ((q, k,
    v), {"causal", "window"}) per launch."""
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
        fn()
    finally:
        K3.flash_attention = launch
    return got


def attention_timing(dev, q_shape, kv_shape, copies=8):
    """K3 non-causal at one shape in bf16 (inputs cycled over ``copies``
    sets, as every layer finds its K/V cold), its plain version ref.mha
    and SDPA, and the least time: the bytes once at the memory rate or the
    products at the bf16 tensor-core rate."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as K3
    from repro_torch.kernels.flash_attention import ref
    b, hq, sq, d = q_shape
    hkv, skv = kv_shape[1], kv_shape[2]
    xs = [fa_case(71 + i, torch.bfloat16, dev, b=b, hq=hq, hkv=hkv, sq=sq,
                  skv=skv, d=d) for i in range(copies)]
    it = itertools.count()

    def pick():
        return xs[next(it) % len(xs)]
    out = {"k3": timed(lambda: K3.flash_attention(*pick(), causal=False)),
           "plain": timed(lambda: ref.mha(*pick(), causal=False), iters=20),
           "sdpa": timed(lambda: F.scaled_dot_product_attention(
               *pick(), enable_gqa=hq != hkv))}
    nbytes = (2 * b * hq * sq * d + 2 * b * hkv * skv * d) * 2
    ops = 4 * d * sq * skv * b * hq
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS_PER_S
    return {"shape": [b, hq, hkv, sq, skv, d],
            "ms": out["k3"]["device_ms"], "plain_ms": out["plain"]["device_ms"],
            "sdpa_ms": out["sdpa"]["device_ms"],
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "clocks": out}


def k4_timing(dev, hkv, g, d, s, err):
    """K4 at one decode shape in bf16 (B 8, ragged lengths, 16 input sets
    cycled): held to its plain version (check_k4), then its time beside
    the plain version's, SDPA's with a boolean mask and the bytes bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_decode import flash as K4
    from repro_torch.kernels.paged_decode import flash_ops
    fd = [fd_case(81 + i, torch.bfloat16, dev, g=g, d=d, s=s, hkv=hkv)
          for i in range(16)]
    check_k4(fd[0], None, err)
    it = itertools.count()

    def pick(xs):
        return xs[next(it) % len(xs)]
    qg = [(x[0].reshape(B, hkv, g, d), x[1], x[2], x[3]) for x in fd]
    pos = torch.arange(s, device=dev)
    lib = [(x[0][:, :, None], x[1], x[2],
            (pos[None, :] < x[3][:, None].long())[:, None, None, :])
           for x in fd]

    def library():
        q4, k4, v4, mask = pick(lib)
        F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                       enable_gqa=g > 1)
    k4 = timed(lambda: K4.flash_decode(*pick(qg)))
    plain = timed(lambda: flash_ops.decode_attention_partial(
        *pick(fd)[:4], use_kernel=False), iters=20)
    lib_t = timed(library)
    attended = int(np.minimum(fd[0][4], s).sum())
    nbytes = (2 * attended * hkv * d * 2 + 2 * B * hkv * g * d * 2 + 4 * B
              + 2 * B * hkv * g * 4)
    ops = 4 * g * d * hkv * attended
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S
    return {"shape": [B, hkv, g, s, d], "ms": k4["device_ms"],
            "plain_ms": plain["device_ms"], "sdpa_ms": lib_t["device_ms"],
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_encdec(dev):
    """seamless-m4t-medium at its published widths (random weights from
    seed 0) on SyntheticLM's frame embeddings (B 8, S_src 512, seed 0).

    bf16, the counted path: prepare_cross_cache (the encoder: K3
    non-causal, once a layer, on the tensor cores at D 64), then 64 greedy
    decode steps from token 0, each decoder layer launching K1 with its
    page write off (the rotary), K4 (self-attention, D 64, G 1) and K3
    (cross-attention, Sq 1 against Skv 512): K3 12 + 12 x 64, K1 = K4 =
    12 x 64.  Then the lockstep gate of phase archs: 64 steps of the
    kernel decode, each also run by the plain path (attn_impl "ref") and
    by the plain path summed in another order (cross-attention over
    128-key chunks, the self-attention's q.k in reverse) from the kernel
    decode's cache before the step; the kernels' logits within the larger
    of LOGIT_RTOL and ORDER_FACTOR times the plain path's own disagreement.
    K3 on every layer's real inputs (the encoder's and one step's cross-
    attention at Sq 1) within check_k3_real's tolerance; K3 at Sq 640 >
    Skv 512 non-causal (bf16 on both variants, f32) within phase 6's,
    and a causal Sq > Skv refused; K1's rotary at base 1e4 against its
    plain version, bit for bit reported.  f32: the kernel decoder's 64
    greedy tokens equal the plain decoder's on one encoder output; the
    lockstep gate; K3 on each encoder layer's real inputs within the
    larger of phase 6's tolerance and ORDER_FACTOR times ref.mha's own
    error, both against float64; K4 at the decode shape; ``lm_loss`` of
    the batch with the kernels (no grad) against "chunked" within
    max(1e-4, ORDER_FACTOR x "ref" against "chunked"), relative; the whole
    paths' free-running tokens, where they part and the encoder outputs'
    distance reported.  Every gate is read before the phase fails, and a
    failing phase prints its line first.  Timings: a profiled bf16 decode
    step against the read of its weights (and of its caches); K3 at Sq 1 /
    Skv 512 / D 64 with SDPA's time; K4 at D 64 / G 1.  Returns ({kernel:
    launches on the counted path}, results)."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as K3
    from repro_torch.kernels.paged_decode import flash as K4
    from repro_torch.kernels.paged_decode import kernel as K
    from repro_torch.models import encdec as E
    from repro_torch.models.model import Model
    cfg = encdec_cfg("bfloat16")
    model = Model(cfg, device=dev, seed=0)
    batch = encdec_batch(cfg, dev)
    embeds = batch["embeds"]
    n = cfg.n_layers
    res = {"model": cfg.name, "shape": {"batch": ENCDEC_B,
                                        "src_len": ENCDEC_SRC,
                                        "steps": ENCDEC_STEPS}}
    # warm-up, then the encoder alone: K3 once per encoder layer
    encdec_decode(model, embeds[:, :64], 2)
    torch.cuda.synchronize()
    # bf16 at D 64: the tensor cores
    tc = K3.variant_for(torch.bfloat16, cfg.hd) == "tensor_core"
    K3.reset_launch_counts()
    model.encode(embeds)
    if K3.LAUNCHES != {"flash_attention": cfg.n_encoder_layers,
                       "flash_attention_tc": cfg.n_encoder_layers * tc}:
        raise AssertionError(f"encode: K3 launches {K3.LAUNCHES}")
    for mod in (K, K3, K4):
        mod.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks_k, _, _ = encdec_decode(model, embeds, ENCDEC_STEPS)
    torch.cuda.synchronize()
    res["serve_s"] = time.perf_counter() - t0
    launches = {"flash_attention": K3.LAUNCHES["flash_attention"],
                "flash_decode": K4.LAUNCHES["flash_decode"],
                "paged_kv_write": K.LAUNCHES["paged_kv_write"]}
    want = {"flash_attention": cfg.n_encoder_layers + n * ENCDEC_STEPS,
            "flash_decode": n * ENCDEC_STEPS,
            "paged_kv_write": n * ENCDEC_STEPS}
    if launches != want or K3.LAUNCHES["flash_attention_tc"] != want[
            "flash_attention"] * tc or K.LAUNCHES["paged_gather_attend"]:
        raise AssertionError(f"encdec launches {launches}, K3 tensor cores "
                             f"{K3.LAUNCHES['flash_attention_tc']}, K2 "
                             f"{K.LAUNCHES['paged_gather_attend']}; want "
                             f"{want}")
    res["launches"] = launches
    res["decode_step_ms"] = res["serve_s"] / ENCDEC_STEPS * 1e3
    failed = []
    res["bf16_lockstep"] = encdec_lockstep(model, embeds, "bfloat16")
    if not res["bf16_lockstep"]["ok"]:
        failed.append("bf16 lockstep logits")
    # K3 on real inputs: the encoder's layers, and one step's cross-attention
    err = {"k3": 0.0, "k3_real": 0.0, "k4": 0.0}
    cache = model.prepare_cross_cache(embeds, model.init_cache(
        ENCDEC_B, ENCDEC_STEPS, src_len=ENCDEC_SRC))
    tok = toks_k[0].to(dev, torch.int32)[:, None]
    lengths = torch.ones(ENCDEC_B, dtype=torch.int32, device=dev)
    real = k3_inputs(lambda: model.encode(embeds)) + k3_inputs(
        lambda: model.decode_step(tok, cache, lengths))
    for args, kw in real:
        check_k3_real(*args, kw["causal"], kw["window"], err)
    # beside the gate: K3 and ref.mha each against float64 on these inputs
    f64 = [k3_f64_errors(*args, **kw) for args, kw in real]
    res["k3_real_inputs"] = {
        "launches": len(real), "max_abs_err": err["k3_real"],
        "shapes": sorted({str(list(a[0].shape)) for a, _ in real}),
        "vs_float64": {"k3": max(r["k3"] for r in f64),
                       "plain": max(r["plain"] for r in f64),
                       "max_abs_logit": max(r["max_abs_logit"]
                                            for r in f64)}}
    del real, f64
    # K3 with queries past the source: both variants, and f32
    for dt, variant in ((torch.bfloat16, None), (torch.bfloat16, "cuda_core"),
                        (torch.float32, None)):
        q, k, v = fa_case(73, dt, dev, b=2, hq=cfg.n_heads,
                          hkv=cfg.n_kv_heads, sq=ENCDEC_LONG_Q,
                          skv=ENCDEC_SRC, d=cfg.hd)
        check_k3(q, k, v, False, None, err, variant=variant)
    try:
        K3.flash_attention(q, k, v, causal=True)
    except ValueError:
        pass
    else:
        raise AssertionError("K3 took a causal Sq > Skv")
    res["k3_long_q"] = {"sq": ENCDEC_LONG_Q, "skv": ENCDEC_SRC,
                        "max_abs_err": err["k3"]}
    # where a bf16 decode step's time goes, against the read of its weights
    step_len = torch.full((ENCDEC_B,), ENCDEC_STEPS // 2, dtype=torch.int32,
                          device=dev)

    def step():
        model.decode_step(tok, cache, step_len)
    t = timed(step, iters=20)
    dev_ms, by_name = device_profile(step, iters=10)
    weight_bytes = sum(p.numel() * p.element_size() for p in (
        *model.params["dec"].parameters(), model.params["embed"]["head"],
        model.params["ln_f"]["w"]))
    cache_bytes = sum(cache[name][:, :, :, :ENCDEC_STEPS // 2].numel() * 2
                      for name in ("k", "v")) + sum(
        cache[name].numel() * 2 for name in ("xk", "xv"))
    res["profile"] = {
        "device_ms_per_step": t["device_ms"], "clock": t["clock"],
        "profiler_ms_per_step": dev_ms,
        "device_ops_per_step": by_name.get("device_ops_per_call"),
        "kernel_ms_per_step": {
            name: sum(v for k, v in by_name.items()
                      if any(sym in k for sym in syms))
            for name, syms in KERNEL_SYMBOLS.items()},
        "weight_bytes": weight_bytes,
        "weight_read_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
        "cache_bytes": cache_bytes,
        "bytes_bound_ms": (weight_bytes + cache_bytes) / HBM_BYTES_PER_S
        * 1e3}
    del cache
    res["k3_sq1"] = attention_timing(
        dev, (ENCDEC_B, cfg.n_heads, 1, cfg.hd),
        (ENCDEC_B, cfg.n_kv_heads, ENCDEC_SRC, cfg.hd))
    res["k4_d64_g1"] = k4_timing(dev, cfg.n_kv_heads,
                                 cfg.n_heads // cfg.n_kv_heads, cfg.hd,
                                 ENCDEC_STEPS, err)
    # K1's rotary at seamless's base (1e4) and head dim, no q/k norm: bit
    # for bit with its plain version, as phase kernels holds it at 1e6
    from repro_torch.kernels.paged_decode import ref as pd_ref
    rng = np.random.default_rng(75)
    res["k1_rotary_bits_equal"] = {}
    for dt in (torch.float32, torch.bfloat16):
        q1, k1 = (torch.tensor(rng.normal(size=(ENCDEC_B, h, cfg.hd)).astype(
            np.float32), device=dev).to(dt) for h in (cfg.n_heads,
                                                      cfg.n_kv_heads))
        ln = torch.tensor(rng.integers(1, 4096, ENCDEC_B), dtype=torch.int32,
                          device=dev)
        got = K.qk_rotate(q1, k1, ln, rope_theta=cfg.rope_theta)
        want = pd_ref.qk_rotate(q1, k1, ln, rope_theta=cfg.rope_theta)
        res["k1_rotary_bits_equal"][str(dt).split(".")[1]] = all(
            bool(torch.equal(bits(a), bits(w))) for a, w in zip(got, want))
    res["max_abs_err"] = err
    del model
    torch.cuda.empty_cache()
    # f32: greedy tokens free-running (the kernels, the plain path and the
    # plain path reordered), the lockstep gate, K4 and K1 at the decode
    # shapes, and lm_loss with the kernels
    cfg32 = encdec_cfg("float32")
    m32 = Model(cfg32, device=dev, seed=0)
    b32 = encdec_batch(cfg32, dev)
    plain = m32.with_config(dataclasses.replace(cfg32, attn_impl="ref"))
    reordered = m32.with_config(dataclasses.replace(
        cfg32, attn_impl="chunked", attn_chunk_q=128, attn_chunk_k=128))
    top_k, top_p = [], []
    toks, _, _ = encdec_decode(m32, b32["embeds"], ENCDEC_STEPS, top2=top_k)
    toks_p, _, _ = encdec_decode(plain, b32["embeds"], ENCDEC_STEPS,
                                 top2=top_p)
    with ReversedDecodeDots():
        toks_r, _, _ = encdec_decode(reordered, b32["embeds"], ENCDEC_STEPS)
    div = first_divergence(toks, toks_p)
    # each path's gap between its two largest logits where it parts
    gaps = [None if i is None else
            [float(t[i][j, 0] - t[i][j, 1]) for t in (top_k, top_p)]
            for j, i in enumerate(div)]
    # which half parts them: the plain decoder on the kernels' encoder
    # output, and the kernels' decoder on the plain encoder's
    with torch.no_grad():
        cross_k = m32.prepare_cross_cache(b32["embeds"], m32.init_cache(
            ENCDEC_B, 1, src_len=ENCDEC_SRC))
        cross_p = plain.prepare_cross_cache(b32["embeds"], plain.init_cache(
            ENCDEC_B, 1, src_len=ENCDEC_SRC))
        cross_r = reordered.prepare_cross_cache(
            b32["embeds"], plain.init_cache(ENCDEC_B, 1, src_len=ENCDEC_SRC))
    toks_pk, _, _ = encdec_decode(plain, b32["embeds"], ENCDEC_STEPS,
                                  cross={n: cross_k[n] for n in ("xk", "xv")})
    toks_kp, _, _ = encdec_decode(m32, b32["embeds"], ENCDEC_STEPS,
                                  cross={n: cross_p[n] for n in ("xk", "xv")})
    lock = encdec_lockstep(m32, b32["embeds"], "float32")
    f32 = {"tokens_identical": bool(torch.equal(toks, toks_p)),
           "first_divergence": div, "top2_gap_at_divergence": gaps,
           "cross_rel": {n: rel_err(cross_k[n], cross_p[n])
                         for n in ("xk", "xv")},
           "cross_rel_plain_reordered": {n: rel_err(cross_r[n], cross_p[n])
                                         for n in ("xk", "xv")},
           "plain_on_kernel_encoder_first_divergence": first_divergence(
               toks_pk, toks_p),
           "kernel_on_plain_encoder_identical": bool(torch.equal(toks_kp,
                                                                 toks_p)),
           "plain_reordered_identical": bool(torch.equal(toks_r, toks_p)),
           "plain_reordered_first_divergence": first_divergence(toks_r,
                                                                toks_p),
           "lockstep": lock}
    del cross_k, cross_p, cross_r
    # K3 (the CUDA cores in f32) on the f32 encoder's real inputs, against
    # float64 beside its plain version's error
    real = k3_inputs(lambda: m32.encode(b32["embeds"]))
    f32["k3_real_f64"] = [k3_f64_errors(*args, **kw) for args, kw in real]
    del real
    if not all(r["ok"] for r in f32["k3_real_f64"]):
        failed.append("f32 K3 on the encoder's real inputs")
    err32 = {"k4": 0.0}
    res["f32"] = f32
    # the greedy tokens: the kernel decoder's equal the plain decoder's on
    # one encoder output.  The whole paths' are reported: their encoders'
    # outputs part by ~1e-4 after 12 random-weight layers whose scaled
    # logits reach ~500 (K3 lies closer to float64 there than ref.mha,
    # k3_real_f64), and a decode fed either output parts from the other at
    # a near-tie some dozens of steps on
    if not f32["kernel_on_plain_encoder_identical"]:
        failed.append("f32 greedy tokens")
    if not f32["lockstep"]["ok"]:
        failed.append("f32 lockstep logits")
    for seed in (83, 84):
        check_k4(fd_case(seed, torch.float32, dev, g=1, d=cfg.hd,
                         s=ENCDEC_STEPS, hkv=cfg.n_kv_heads), None, err32)
    f32["k4_max_abs_err"] = err32["k4"]
    K3.reset_launch_counts()
    loss = {}
    with torch.no_grad():
        for impl in ("pallas", "chunked", "ref"):
            loss[impl] = E.lm_loss(dataclasses.replace(cfg32, attn_impl=impl),
                                   m32.params, b32, m32.periods()).item()
    if K3.LAUNCHES["flash_attention"] != cfg.n_encoder_layers + 2 * n:
        raise AssertionError(f"lm_loss: K3 launches {K3.LAUNCHES}")
    rel_loss = abs(loss["pallas"] - loss["chunked"]) / abs(loss["chunked"])
    floor = abs(loss["ref"] - loss["chunked"]) / abs(loss["chunked"])
    lim = max(1e-4, ORDER_FACTOR * floor)
    f32.update(lm_loss=loss, lm_loss_rel=rel_loss, lm_loss_limit=lim)
    if not np.isfinite(rel_loss) or rel_loss > lim:
        failed.append("f32 lm_loss")
    del m32, plain, reordered, b32
    torch.cuda.empty_cache()
    if failed:
        emit({"phase": "encdec", "failed": failed, **res})
        raise AssertionError(f"phase encdec failed: {failed}")
    return launches, res


# -- phase 19 ------------------------------------------------------------------

#: phase train: qwen3-0.6b at full width, bf16 parameters with f32
#: masters, remat "block", SyntheticLM(8 x 512, seed 0),
#: warmup_cosine(3e-3, 5, 10) over 10 steps, a checkpoint at step 5
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_SAVE_AT = 8, 512, 10, 5
#: step 1 with 2 microbatches against 1, relative: the rows' arithmetic is
#: the same but for the matmuls' tiling over half the rows, and the
#: gradient sums round each half's bf16 gradient before the f32 sum
TRAIN_MICRO_RTOL = {"loss": 1e-2, "grad_norm": 2e-2}
#: seamless-m4t-medium's two steps: B 4 x S 256 on one batch
TRAIN_ENCDEC_B, TRAIN_ENCDEC_S = 4, 256


def train_cfg(arch: str, **kw):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), **{
        "param_dtype": "bfloat16", "compute_dtype": "bfloat16",
        "remat": "block", **kw})


def trainer_for(cfg, dev, microbatches: int = 1, seed: int = 0, mesh=None):
    """A Trainer of ``cfg`` on ``dev`` (on ``mesh`` where one is given)
    with the phase's schedule, and its initial (params, opt) from
    ``seed``."""
    from repro_torch.models.model import Model
    from repro_torch.optim import AdamWConfig, schedules
    from repro_torch.train.trainer import TrainConfig, Trainer
    trainer = Trainer(Model(cfg, device=dev, seed=seed), mesh, AdamWConfig(
        lr=schedules.warmup_cosine(3e-3, 5, TRAIN_STEPS)),
        TrainConfig(microbatches=microbatches))
    return (trainer, *trainer.init_state(seed))


def grad_guard_raises(model, batch) -> list[str]:
    """The loss of ``model`` (parameters requiring grad) under attn_impl
    "pallas" raises at the kernel's grad guard before any launch; returns
    the guard's messages."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as K3
    from repro_torch.kernels.mamba2_ssd import kernel as K5
    m = model.with_config(dataclasses.replace(model.cfg, attn_impl="pallas"))
    before = {**K3.LAUNCHES, **K5.LAUNCHES}
    try:
        with torch.enable_grad():
            m.loss(batch)
    except RuntimeError as e:
        if "no backward" not in str(e):
            raise
        msg = str(e)
    else:
        raise AssertionError(f"{model.cfg.name}: a loss through the kernels "
                             "took gradients")
    if {**K3.LAUNCHES, **K5.LAUNCHES} != before:
        raise AssertionError("the grad guard let a kernel launch")
    return msg


def phase_train(dev):
    """Training on one card through the plain paths (attn_impl "chunked",
    no kernel launch), torch's deterministic algorithms on: qwen3-0.6b 10
    steps (the loss falls; a checkpoint at step 5 written by the async
    saver, restored into a fresh Trainer from the files, and steps 6-10
    run again bit for bit equal to the uninterrupted run: losses, grad
    norms and every parameter); step 1 with 2 microbatches against 1
    within TRAIN_MICRO_RTOL; two steps of seamless-m4t-medium's lm_loss at
    full width (B 4 x S 256, one batch twice) with finite gradients and a
    falling loss; the kernels' grad guard raising for K3 (qwen3's
    attention) and K5 (one mamba2-780m layer).  Reports step ms, tokens/s,
    the step's share of its compute bound (6 x parameters x tokens at the
    bf16 tensor-core rate) and peak memory."""
    import shutil
    import tempfile
    import torch
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels.flash_attention import kernel as K3
    from repro_torch.kernels.mamba2_ssd import kernel as K5
    from repro_torch.models.model import Model
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.tree import flatten
    det = torch.are_deterministic_algorithms_enabled()
    # the embedding's backward accumulates by index: sorted, not atomics
    torch.use_deterministic_algorithms(True, warn_only=True)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="train_ckpt_",
                                dir=os.path.join(ROOT, "build"))
    res = {}
    try:
        K3.reset_launch_counts()
        K5.reset_launch_counts()
        cfg = train_cfg("qwen3-0.6b")
        data = SyntheticLM(cfg, DataConfig(TRAIN_B, TRAIN_S, seed=0))
        trainer, params, opt = trainer_for(cfg, dev)
        ckpt = CheckpointManager(ckpt_dir)
        torch.cuda.reset_peak_memory_stats(dev)
        save = [lambda step, p, o, m: ckpt.save(step, {"params": p, "opt": o})
                if step == TRAIN_SAVE_AT else None]
        params, opt, hist = trainer.run(params, opt, iter(data), TRAIN_STEPS,
                                        save)
        peak = torch.cuda.max_memory_allocated(dev)
        ckpt.wait()
        first, last = hist[0]["loss"], hist[-1]["loss"]
        if not all(np.isfinite([h["loss"] for h in hist])) or last >= first:
            raise AssertionError(f"qwen3 training loss {first} -> {last}")
        final = {k: v.detach().clone() for k, v in flatten(params).items()}
        n_params = trainer.model.param_count()
        del trainer, params, opt
        torch.cuda.empty_cache()
        # resume from the files into a fresh Trainer (other weights first)
        trainer, params, opt = trainer_for(cfg, dev, seed=1)
        params, opt, step = trainer.restore(CheckpointManager(ckpt_dir),
                                            TRAIN_SAVE_AT)
        params, opt, again = trainer.run(params, opt,
                                         data.iter_from(TRAIN_SAVE_AT),
                                         TRAIN_STEPS - TRAIN_SAVE_AT)
        same = [a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
                and a["step"] == b["step"]
                for a, b in zip(hist[TRAIN_SAVE_AT:], again)]
        leaves_equal = all(torch.equal(final[k], v)
                           for k, v in flatten(params).items())
        if not (all(same) and leaves_equal):
            raise AssertionError(
                f"resumed run differs from the uninterrupted one: steps "
                f"equal {same}, parameters equal {leaves_equal}")
        del trainer, params, opt, final
        torch.cuda.empty_cache()
        # microbatches: step 1 of 2 halves against the whole batch
        trainer, params, opt = trainer_for(cfg, dev, microbatches=2)
        _, _, micro = trainer.run(params, opt, iter(data), 1)
        rel_micro = {k: abs(micro[0][k] - hist[0][k]) / abs(hist[0][k])
                     for k in TRAIN_MICRO_RTOL}
        if any(not np.isfinite(r) or r > TRAIN_MICRO_RTOL[k]
               for k, r in rel_micro.items()):
            raise AssertionError(f"2 microbatches vs 1: {rel_micro} > "
                                 f"{TRAIN_MICRO_RTOL}")
        # where a step's time goes (one more step of this trainer)
        one = data.global_batch(1)
        prof_ms, by_name = device_profile(
            lambda: trainer.run(params, opt, iter([one]), 1), iters=1,
            warmup=0)
        top = sorted(((k, v) for k, v in by_name.items()
                      if k != "device_ops_per_call"), key=lambda kv: -kv[1])
        small = {k: torch.as_tensor(v[:1, :64]).to(dev)
                 for k, v in data.global_batch(0).items()}
        guard = {"k3": grad_guard_raises(trainer.model, small)}
        del trainer, params, opt
        torch.cuda.empty_cache()
        steps_ms = [h["step_time_s"] * 1e3 for h in hist[1:]]
        step_ms = float(np.median(steps_ms))
        bound_ms = 6 * n_params * TRAIN_B * TRAIN_S / BF16_FLOPS_PER_S * 1e3
        res["qwen3"] = {
            "steps": TRAIN_STEPS, "batch": [TRAIN_B, TRAIN_S],
            "loss": [h["loss"] for h in hist],
            "grad_norm": [h["grad_norm"] for h in hist],
            "lr": [h["lr"] for h in hist], "first_loss": first,
            "last_loss": last, "improved": last < first,
            "resumed_equal_bits": True, "resumed_from": step,
            "micro2_rel": rel_micro, "micro2_rtol": TRAIN_MICRO_RTOL,
            "step_ms_median": step_ms, "step_ms": steps_ms,
            "first_step_ms": hist[0]["step_time_s"] * 1e3,
            "tokens_per_s": TRAIN_B * TRAIN_S / step_ms * 1e3,
            "params": n_params, "compute_bound_ms": bound_ms,
            "bound_share": bound_ms / step_ms,
            "peak_memory_bytes": peak,
            "profiled_step": {"device_ms": prof_ms,
                              "device_ops": by_name.get("device_ops_per_call"),
                              "top_kernels_ms": [[k[:80], v]
                                                 for k, v in top[:8]]}}
        # seamless: two steps of the enc-dec lm_loss on one batch
        ecfg = train_cfg("seamless-m4t-medium")
        batch = SyntheticLM(ecfg, DataConfig(TRAIN_ENCDEC_B, TRAIN_ENCDEC_S,
                                             seed=0)).global_batch(0)
        trainer, params, opt = trainer_for(ecfg, dev)
        _, _, ehist = trainer.run(params, opt, iter([batch, batch]), 2)
        losses = [h["loss"] for h in ehist]
        norms = [h["grad_norm"] for h in ehist]
        if not (np.isfinite(losses + norms).all() and losses[1] < losses[0]):
            raise AssertionError(f"seamless training: losses {losses}, grad "
                                 f"norms {norms}")
        res["seamless"] = {"batch": [TRAIN_ENCDEC_B, TRAIN_ENCDEC_S],
                           "loss": losses, "grad_norm": norms,
                           "step_ms": [h["step_time_s"] * 1e3
                                       for h in ehist]}
        del trainer, params, opt
        torch.cuda.empty_cache()
        # K5's guard: one mamba2-780m layer
        mcfg = train_cfg("mamba2-780m", n_layers=1)
        m = Model(mcfg, device=dev, seed=0)
        m.params.requires_grad_(True)
        mb = {k: torch.as_tensor(v).to(dev) for k, v in SyntheticLM(
            mcfg, DataConfig(1, 128, seed=0)).global_batch(0).items()}
        guard["k5"] = grad_guard_raises(m, mb)
        del m
        res["grad_guard"] = guard
        launched = {**K3.LAUNCHES, **K5.LAUNCHES}
        if any(launched.values()):
            raise AssertionError(f"training launched kernels: {launched}")
    finally:
        torch.use_deterministic_algorithms(det)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        torch.cuda.empty_cache()
    return res


# -- phase 20 ------------------------------------------------------------------

#: phase mesh_train's steps (phase train's model, data and schedule), and
#: the steps each trainer then takes in turns for their wall times
MESH_TRAIN_STEPS, MESH_TIMING_PAIRS = 5, 3


def step_profile(fn) -> dict:
    """One call of ``fn`` under torch.profiler: its device ms (every kernel
    and copy), device ops, and the NCCL kernels among them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        raise AssertionError("the profiler saw no device time in a step")
    return {"device_ms": sum(e.device_time_total for e in dev) / 1e3,
            "device_ops": len(dev),
            "nccl_kernels": sum("nccl" in e.name.lower() for e in dev)}


def phase_mesh_train(dev):
    """Training on a mesh at world 1: an NCCL process group of one rank and
    a (1, 1) ("data", "model") DeviceMesh under the ``fsdp_tp`` rules,
    phase train's qwen3-0.6b (full width, bf16 with f32 masters, remat
    "block", 8 x 512, the same schedule) for MESH_TRAIN_STEPS steps, torch's
    deterministic algorithms on: every step's loss and grad norm and every
    final weight (the model's tensors, and the gathered DTensor state)
    equal the one-device trainer's over the same steps bit for bit; the
    state checkpointed from the mesh (async, rank 0 writing) and restored
    by ``elastic_restore`` onto one device equals the one-device state bit
    for bit.  Then MESH_TIMING_PAIRS more steps of each, in turns (one
    card, mesh), still bit for bit: their wall ms, and one profiled step
    of each (device ms and ops, the NCCL kernels the card ran).  Reports
    the collectives a step issues, the memory each run's state holds and
    its peak above that, and the seconds of each part.  The group is
    destroyed at the end."""
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import init_process_group, make_host_mesh
    from repro_torch.train import trainer as T
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.fault_tolerance import elastic_restore
    from repro_torch.tree import flatten, unflatten
    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="mesh_ckpt_",
                                dir=os.path.join(ROOT, "build"))
    store = os.path.join(ROOT, "build", f"mesh_train_store_{os.getpid()}")
    if os.path.exists(store):
        os.remove(store)
    cfg = train_cfg("qwen3-0.6b")
    data = SyntheticLM(cfg, DataConfig(TRAIN_B, TRAIN_S, seed=0))
    res = {"steps": MESH_TRAIN_STEPS, "batch": [TRAIN_B, TRAIN_S],
           "rules": "fsdp_tp", "mesh": {"data": 1, "model": 1}}
    parts = res["part_s"] = {}
    clock = [time.monotonic()]

    def part(name):
        now = time.monotonic()
        parts[name] = now - clock[0]
        clock[0] = now

    def measured_run(trainer, params, opt, base, hooks=None):
        """The steps, with the memory the run's state holds above ``base``
        (what was allocated before its trainer) and the run's peak above
        that."""
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        params, opt, hist = trainer.run(params, opt, iter(data),
                                        MESH_TRAIN_STEPS, hooks)
        mem = {"state_bytes": held - base,
               "peak_above_state_bytes":
                   torch.cuda.max_memory_allocated(dev) - held}
        return params, opt, hist, mem

    def summary(hist, mem):
        return {"loss": [h["loss"] for h in hist],
                "grad_norm": [h["grad_norm"] for h in hist],
                "step_ms": [h["step_time_s"] * 1e3 for h in hist],
                "memory": mem}
    try:
        # one device: the reference run
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        one, p1, o1 = trainer_for(cfg, dev)
        p1, o1, hist_one, mem_one = measured_run(one, p1, o1, base)
        res["one_device"] = summary(hist_one, mem_one)
        part("one_device")
        # the mesh
        res["backend"] = init_process_group(dev, rank=0, world_size=1,
                                            init_method=f"file://{store}")
        mesh = make_host_mesh(device=dev)
        if res["backend"] != "nccl" or dist.get_backend() != "nccl":
            raise AssertionError(f"backend {dist.get_backend()}")
        part("group_start")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        trainer, params, opt = trainer_for(cfg, dev, mesh=mesh)
        placed = flatten({"params": params, "opt": opt})
        if not all(isinstance(v, DTensor) for v in placed.values()):
            raise AssertionError("the mesh trainer's state is not DTensors")
        del placed
        ckpt = CheckpointManager(ckpt_dir)
        save = [lambda step, p, o, m: ckpt.save(step, {"params": p, "opt": o})
                if step == MESH_TRAIN_STEPS else None]
        T.reset_calls()
        params, opt, hist, mem = measured_run(trainer, params, opt, base,
                                              save)
        calls = dict(T.CALLS)
        ckpt.wait()
        part("mesh_steps_and_save")
        want = flatten({"params": p1, "opt": o1})
        same_steps = [a["loss"] == b["loss"]
                      and a["grad_norm"] == b["grad_norm"]
                      for a, b in zip(hist, hist_one)]
        model_equal = all(same_bits(v, want[f"params/{k}"]) for k, v in
                          flatten(trainer.model.param_tree()).items())
        state = flatten({"params": params, "opt": opt})
        state_equal = all(same_bits(v.full_tensor(), want[k])
                          for k, v in state.items())
        res["mesh"] = {**summary(hist, mem),
                       "steps_equal_bits": same_steps,
                       "weights_equal_bits": model_equal,
                       "state_equal_bits": state_equal,
                       "collectives": calls,
                       "collectives_per_step":
                           sum(calls.values()) / MESH_TRAIN_STEPS}
        if not (all(same_steps) and model_equal and state_equal):
            raise AssertionError(
                f"mesh training differs from one device: steps {same_steps}, "
                f"weights {model_equal}, state {state_equal}")
        # the checkpoint from the mesh, onto one device
        like = unflatten({"params": params, "opt": opt},
                         {k: torch.zeros(()) for k in state})
        restored, step = elastic_restore(CheckpointManager(ckpt_dir), like,
                                         dev)
        back = flatten(restored)
        restored_equal = step == MESH_TRAIN_STEPS and all(
            same_bits(back[k], want[k]) for k in want)
        res["restored_on_one_device_equal_bits"] = restored_equal
        if not restored_equal:
            raise AssertionError("the mesh checkpoint restored onto one "
                                 "device differs")
        del restored, back, want, state
        torch.cuda.empty_cache()
        part("compare_and_restore")
        # in turns, on the same batches: wall ms, then one profiled step
        walls = {"one_device": [], "mesh": []}
        for i in range(MESH_TIMING_PAIRS):
            batch = data.global_batch(MESH_TRAIN_STEPS + i)
            p1, o1, a = one.run(p1, o1, iter([batch]), 1)
            params, opt, b = trainer.run(params, opt, iter([batch]), 1)
            if (a[0]["loss"], a[0]["grad_norm"]) != (b[0]["loss"],
                                                    b[0]["grad_norm"]):
                raise AssertionError(f"timing pair {i} differs")
            walls["one_device"].append(a[0]["step_time_s"] * 1e3)
            walls["mesh"].append(b[0]["step_time_s"] * 1e3)
        batch = data.global_batch(MESH_TRAIN_STEPS + MESH_TIMING_PAIRS)
        for name, (tr, p, o) in (("one_device", (one, p1, o1)),
                                 ("mesh", (trainer, params, opt))):
            res[name]["paired_step_ms"] = walls[name]
            res[name]["profiled_step"] = step_profile(
                lambda: tr.run(p, o, iter([batch]), 1))
        part("paired_and_profiled")
        del trainer, params, opt, one, p1, o1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        torch.use_deterministic_algorithms(det)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        if os.path.exists(store):
            os.remove(store)
        torch.cuda.empty_cache()
    if dist.is_initialized():
        raise AssertionError("the process group outlived phase mesh_train")
    return res


# -- phase 21 ------------------------------------------------------------------

def load_example(name: str):
    """``examples/<name>.py`` as a module (its ``main`` not run)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_paper(dev):
    """The paper's analytic models on the card's machine (no JAX):
    ``benchmarks/figs_torch.py``'s rows of Figs. 5-13 and §7.3 (176 rows
    with the reference modules' names), held to the paper's headline
    claims (the DDR3 35 ns baseline; the folded Clos at 2-5x DDR3 from 512
    tiles; Dhrystone and the compiler at 1.8-3.0x over a 1024- and a
    4096-tile machine, a speed-up at 16 tiles); then the two examples on
    the card: ``emulated_memory_demo_torch`` (the analytic sweep and a
    64-hop pointer chase through EMem) and ``quickstart_torch`` (the
    paper's numbers, an EMem read after write, and a tiny LM trained 10
    steps by ``Trainer`` on a world-1 NCCL mesh, its loss falling).
    Prints Fig. 10's slowdowns at 4096 tiles on a line of its own."""
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    from benchmarks import figs_torch
    from repro_torch.core import dram, emulation, latency
    t = time.monotonic()
    rows = figs_torch.rows()
    res = {"rows": len(rows), "rows_s": time.monotonic() - t}
    names = [r["name"] for r in rows]
    if len(rows) != 176 or len(set(names)) != 176:
        raise AssertionError(f"{len(rows)} figure rows")
    base = dram.paper_baseline(1)
    failed = []
    if abs(base - 35.0) > 2.0:
        failed.append("ddr3 baseline")
    fig10 = {}
    for system in (1024, 4096):
        lat = latency.fig9_sweep(system)
        if not all(2.0 <= c / base <= 5.0 for n, c in
                   zip(lat["sizes"], lat["clos"]) if n >= 512):
            failed.append(f"clos latency at {system}")
        sw = emulation.fig10_sweep(system)
        fig10[system] = {k: v[-1] for k, v in sw.items() if k != "sizes"}
        for mix in ("dhrystone", "compiler"):
            if not 1.8 <= sw[f"clos/{mix}"][-1] <= 3.0 \
                    or sw[f"clos/{mix}"][0] >= 1.0:
                failed.append(f"{mix} slowdown at {system}")
    res["ddr3_ns"] = base
    res["fig10_full_machine"] = fig10
    res["rows_fig10_4096"] = [r for r in rows
                              if r["name"] == "fig10/4096sys/4096t"]
    f = fig10[4096]
    print(f"paper: Fig. 10 at 4096 tiles (folded Clos): Dhrystone "
          f"{f['clos/dhrystone']:.2f}x, compiler {f['clos/compiler']:.2f}x "
          f"(paper 2-3x); 2D mesh {f['mesh/dhrystone']:.2f}x, "
          f"{f['mesh/compiler']:.2f}x", flush=True)
    t = time.monotonic()
    demo = load_example("emulated_memory_demo_torch").main(
        ["--device", str(dev)])
    res["demo"] = {"slowdown": demo["slowdown"],
                   "distinct": demo["emem"]["distinct"],
                   "seconds": time.monotonic() - t}
    t = time.monotonic()
    quick = load_example("quickstart_torch").main(["--device", str(dev)])
    loss = quick["training"]["loss"]
    res["quickstart"] = {"ddr3_ns": quick["ddr3_ns"],
                         "clos_ns": quick["clos_ns"],
                         "dhrystone_slowdown": quick["dhrystone_slowdown"],
                         "emem_max_err": quick["emem_max_err"],
                         "training": quick["training"],
                         "seconds": time.monotonic() - t}
    if quick["emem_max_err"] != 0.0:
        failed.append("quickstart EMem read after write")
    if quick["training"]["backend"] != "nccl" or not loss[-1] < loss[0]:
        failed.append("quickstart training")
    if dist.is_initialized():
        failed.append("quickstart left its group running")
    if failed:
        emit({"phase": "paper", "failed": failed, **res})
        raise AssertionError(f"phase paper failed: {failed}")
    return res


# -- phase 22 ------------------------------------------------------------------

#: phase dryrun's cells: every shape of these archs on the single-pod
#: (16, 16) mesh, and one multi-pod (2, 16, 16) cell
DRYRUN_ARCHS = ("qwen3-0.6b", "mamba2-780m", "mixtral-8x7b")
DRYRUN_MULTI = (("qwen3-0.6b", "train_4k"),)
#: the yardstick's steps, qwen3-0.6b at full width and depth in bf16: the
#: batch-layout decode step of 8 rows over a 512-position cache, and the
#: prefill of 8 prompts of 511 tokens (phases profile and prefill)
YARD_DECODE = (PREFILL_B, PREFILL_MAX_LEN)
YARD_PREFILL = (PREFILL_B, PREFILL_S)
#: the prefill's counted FLOPs against the analytic count
YARD_FLOPS_RTOL = 0.05


def analytic_prefill_flops(cfg, b: int, s: int) -> float:
    """A decoder prefill's FLOPs by hand (PERF.md §2): the projections and
    MLP, 2 x non-embedding params x tokens; causal attention with the
    S-token block counted whole, 4 B H S^2 hd a layer (QK^T and PV), as
    one chunk pair of ``chunked_attention_unrolled`` and K3's plain
    version ``ref.mha`` compute it; the last position's logits, 2 B d V.
    For qwen3-0.6b at 8 x 511: 3.60e12 + 0.479e12 + 2.5e9."""
    emb = cfg.vocab_padded * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    return (2.0 * (cfg.param_count() - emb) * b * s
            + 4.0 * b * cfg.n_heads * s * s * cfg.hd * cfg.n_layers
            + 2.0 * b * cfg.d_model * cfg.vocab_padded)


def step_bytes(model, cache, logits) -> float:
    """The bytes a step must move, each once: every weight read (the tied
    embedding table whole, as the logits read it), the KV cache (read by a
    decode step, written by a prefill) and the logits written."""
    from repro_torch.tree import leaves
    assert model.cfg.tie_embeddings, "an untied input table is read by row"
    return float(sum(t.nbytes for t in leaves({"p": model.param_tree(),
                                               "c": cache}))
                 + logits.nbytes)


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def phase_dryrun(dev):
    """The dry-run and roofline tooling on the card's machine (no JAX): (a)
    ``run_cell`` for DRYRUN_ARCHS over the four shapes on the single-pod
    mesh and DRYRUN_MULTI's cell on the multi-pod one, each one rank's
    step counted on meta tensors over a fake group of 256 or 512 ranks,
    one line per cell (status, dominant term, fits_80gb,
    useful_flops_ratio), every cell ok or skipped; (b) the yardstick: the
    count of YARD_DECODE's and YARD_PREFILL's steps on a (1, 1) fake mesh
    beside their device time on the card (the kernels' paths, bf16): each
    step's roofline bound (counted FLOPs; the memory term from the bytes
    the step must move, :func:`step_bytes`, and beside it from the
    reference's ``analytic_hbm_bytes``, which counts the weights twice, and
    from the counted unfused bytes), its device ms and their ratio, the
    roofline share; the prefill's
    counted FLOPs within YARD_FLOPS_RTOL of :func:`analytic_prefill_flops`;
    (c) ``benchmarks/run_torch.py``'s kernel and emem rows.  No default
    group is left running."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import SHAPES
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import hlo_analysis as H
    from repro_torch.models.model import Model
    sys.path.insert(0, ROOT)
    from benchmarks import run_torch
    if dist.is_initialized():
        raise AssertionError("a process group is running before the dry-run")
    res, failed = {"cells": {}}, []
    t = time.monotonic()
    cells = [(a, s, "single") for a in DRYRUN_ARCHS for s in SHAPES]
    cells += [(a, s, "multi") for a, s in DRYRUN_MULTI]
    for arch, shape, mesh in cells:
        rec = D.run_cell(arch, shape, mesh)
        print(f"dryrun: {D.summary(rec)} ({rec['seconds']:.1f}s)", flush=True)
        keep = {k: rec.get(k) for k in ("status", "seconds", "fits_80gb",
                                        "useful_flops_ratio",
                                        "replicated_over_tp", "error")}
        if rec["status"] == "ok":
            keep.update(dominant=rec["roofline"]["dominant"],
                        bound_s=max(rec["roofline"][k] for k in (
                            "compute_s", "memory_s", "collective_s")),
                        peak_gb=rec["memory"]["peak_bytes"] / 1e9,
                        peak_how=rec["memory"]["how"])
        res["cells"][f"{arch}/{shape}/{mesh}"] = keep
        if rec["status"] not in ("ok", "skipped"):
            failed.append(f"{arch} {shape} {mesh}: {rec.get('error')}")
    res["cells_s"] = time.monotonic() - t
    if dist.is_initialized():
        failed.append("run_cell left a process group running")

    # (b) the yardstick: the counted step beside its device time
    t = time.monotonic()
    cfg = full_cfg("bfloat16", kv_layout="batch", attn_impl="pallas")
    counts = {"decode": D.count_on_one_rank(cfg, "decode", *YARD_DECODE),
              "prefill": D.count_on_one_rank(cfg, "prefill", *YARD_PREFILL)}
    res["count_s"] = time.monotonic() - t
    model = Model(cfg, device=dev, seed=0)
    rng = np.random.default_rng(7)
    b, s = YARD_PREFILL
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (b, s)), device=dev)

    def prefill():
        return model.prefill({"tokens": toks}, YARD_DECODE[1])

    logits, cache = prefill()
    lengths = torch.full((b,), YARD_DECODE[1], dtype=torch.int32, device=dev)
    tok = toks[:, -1:].to(torch.int32)
    steps = {"decode": lambda: model.decode_step(tok, cache, lengths),
             "prefill": prefill}
    moved = step_bytes(model, cache, logits)     # the same for both steps
    res["card"] = card()
    for kind, fn in steps.items():
        c = counts[kind]
        timing = timed(fn, iters=10)
        dev_ms = timing["device_ms"]
        compute_ms = c["roofline"]["compute_s"] * 1e3
        memory_ms = moved / H.HBM_BW * 1e3
        bound = max(compute_ms, memory_ms)
        bound_analytic = max(compute_ms,
                             c["roofline_analytic"]["memory_s"] * 1e3)
        bound_counted = max(compute_ms, c["roofline"]["memory_s"] * 1e3)
        res[kind] = {
            "flops": c["roofline"]["flops"], "bytes_moved": moved,
            "hbm_bytes_counted": c["roofline"]["hbm_bytes"],
            "hbm_bytes_analytic": c["roofline_analytic"]["hbm_bytes"],
            "compute_ms": compute_ms, "memory_ms": memory_ms,
            "memory_ms_analytic": c["roofline_analytic"]["memory_s"] * 1e3,
            "memory_ms_counted": c["roofline"]["memory_s"] * 1e3,
            "bound_ms": bound, "bound_analytic_ms": bound_analytic,
            "bound_counted_ms": bound_counted,
            "peak_gb_counted": c["memory"]["peak_bytes"] / 1e9,
            "device_ms": dev_ms, "clock": timing["clock"],
            "loop_ms": timing["loop_ms"],
            "roofline_share": bound / dev_ms if dev_ms else None,
            "analytic_share": bound_analytic / dev_ms if dev_ms else None,
            "counted_share": bound_counted / dev_ms if dev_ms else None}
        r = res[kind]
        print(f"dryrun: {kind} ({res['card']}): bound {bound:.4g} ms "
              f"({moved / 1e9:.4g} GB moved, {c['roofline']['flops']:.4g} "
              f"FLOPs), device {dev_ms:.4g} ms ({timing['clock']}), "
              f"roofline share {r['roofline_share']:.3g}; beside it "
              f"analytic_hbm_bytes {bound_analytic:.4g} ms (share "
              f"{r['analytic_share']:.3g}), counted unfused bytes "
              f"{bound_counted:.4g} ms", flush=True)
    want = analytic_prefill_flops(cfg, *YARD_PREFILL)
    got = counts["prefill"]["roofline"]["flops"]
    res["prefill"].update(analytic_flops=want, flops_rel=got / want - 1.0)
    print(f"dryrun: prefill counted {got:.6g} FLOPs, analytic {want:.6g} "
          f"({got / want - 1.0:+.2e})", flush=True)
    if not abs(got / want - 1.0) <= YARD_FLOPS_RTOL:
        failed.append(f"prefill FLOPs {got} against {want}")
    del model, cache, logits, steps, prefill
    torch.cuda.empty_cache()
    res["yardstick_s"] = time.monotonic() - t

    # (c) the kernel and emem benches
    t = time.monotonic()
    rows = [r for name, fn in run_torch.modules(dev)
            if name in ("kernel_bench", "emem_bench") for r in fn()]
    for r in rows:
        print(f"dryrun: {r['name']},{r['us_per_call']},{r['derived']}",
              flush=True)
    timed_rows = [r for r in rows if r["us_per_call"] > 0]
    if len(timed_rows) != 8 \
            or not all(np.isfinite(r["us_per_call"]) for r in timed_rows):
        failed.append(f"bench rows {rows}")
    res["bench_rows"] = {r["name"]: r["us_per_call"] for r in rows}
    res["bench_s"] = time.monotonic() - t
    if dist.is_initialized():
        failed.append("a process group is left running")
    if failed:
        emit({"phase": "dryrun", "failed": failed, **res})
        raise AssertionError(f"phase dryrun failed: {failed}")
    return res


# -- phase 23 ------------------------------------------------------------------

#: phase tp_serve (a): K1 + K2 on tensor-parallel shards whose query heads
#: lie inside one KV-head group (a rank's heads at tp > Hkv), at full widths:
#: (arch, head dim, KV-head group, the shard's query heads); 8 KV heads each
TP_SPLIT_SHAPES = (("h2o-danube-1.8b", 80, 4, (2, 1)),
                   ("mixtral-8x7b", 128, 4, (2,)),
                   ("qwen3-0.6b", 128, 2, (1,)))
#: (a)'s bf16 tolerance on acc, m and l: one bf16 rounding (the f32 one
#: is K2_RTOL / K2_ATOL / M_ATOL)
TP_BF16_RTOL = 2.0 ** -7
#: (b) qwen3-0.6b at full width over two processes on the one card: gloo
#: (NCCL takes one card per rank), a (1, 2) ("data", "model") mesh
TP_WORLD = 2
#: (b)'s pooled trace: 4 requests of the serve phase's trace shape with
#: shorter prompts and outputs (75 decode steps), served at CUT_LAYERS's
#: depth (tp_serve_cfg), so that its host-bound steps fit the phase's
#: minute
TP_TRACE = dict(SERVE_TRACE, n_requests=4, prompt_len_short=16,
                prompt_len_long=48, out_len_short=8, out_len_long=16)
#: (b)'s batch layout: one prefill of B x S tokens, then STEPS decode steps
#: of teacher-forced tokens
TP_BATCH, TP_STEPS = (8, 64), 8
#: split form against one card in f32, each step's logits: within
#: TP_LOGIT_RTOL times the largest |logit| plus TP_LOGIT_ATOL
TP_LOGIT_RTOL, TP_LOGIT_ATOL = 2e-4, 1e-4
#: (c) the MoE arch at phase archs' depth (ARCHS_LAYERS), drawn in bf16
#: and held in f32 (two ranks' shards and one card's whole weights in f32
#: fit the card only when drawn so, one rank after the other), its batch
#: layout's prefill and decode steps twice: with the one card's expert
#: choices pinned, as phase archs pins them (the router, whole on every
#: rank, weighs them from its own scores), against the one card computing
#: every product in a rank's shape (TwoRankOrder: 24 random layers turn
#: the last bits the shapes change into 6e-2 of the logits once the
#: router weighs its choices itself, so the plain one card is no
#: yardstick there); and with the choices' weights pinned too, against
#: the one card itself
TP_MOE, TP_MOE_BATCH, TP_MOE_STEPS = "qwen2-moe-a2.7b", (4, 32), 4
#: (c)'s two pinnings: PinnedRouting's modes
TP_MOE_PINS = ("replay", "replay_weights")
#: seconds the two ranks may take before they are killed
TP_TIMEOUT = 300
#: (b)'s bf16 pooled steps timed, and then profiled, per rank and on one
#: card (phase mesh times MESH_PROFILE_STEPS): fewer, for the phase's
#: minute, as each rank's host holds its steps at ~0.3 s
TP_PROFILE_STEPS = 2


def split_group_case(x, hl, head_start, window, err, what):
    """One shard of ``hl`` query heads from ``head_start`` of ``x``'s
    heads: ``ops.paged_decode_shard`` fused (K1 with the rotary, then K2
    on [B, 1, hl, D]) against composed: the pages K1 wrote bit for bit,
    (acc, m, l) within K2's f32 tolerance, or one bf16 rounding in bf16."""
    import torch
    from repro_torch.kernels.paged_decode import ops
    q = x["q"][:, head_start:head_start + hl].contiguous()
    g = x["group"]
    if ops.resolve_impl("auto", hl, g, q.device) != "fused":
        raise AssertionError(f"auto does not take {hl} heads of G {g} fused")
    outs = {impl: ops.paged_decode_shard(
        q, x["k_new"], x["v_new"], x["kp"].clone(), x["vp"].clone(),
        x["lengths"], x["bt"], x["fl"], x["fr"], x["wm"], sid=0, n_shards=1,
        head_start=head_start, group=g, window=window,
        max_pages=x["max_pages"], use_vm=True, impl=impl,
        rope_theta=QKV_THETA) for impl in ("fused", "composed")}
    torch.cuda.synchronize()
    f, c = outs["fused"], outs["composed"]
    if not (torch.equal(f[3], c[3]) and torch.equal(f[4], c[4])):
        raise AssertionError(f"K1 pages differ from plain: {what}")
    bf16 = x["q"].dtype == torch.bfloat16
    for name, a, r in zip("acc m l".split(), f[:3], c[:3]):
        dlt = (a - r).abs()
        err["k2"] = max(err["k2"], dlt.max().item())
        if bf16:
            tol = TP_BF16_RTOL * r.abs() + K2_ATOL
        else:
            tol = M_ATOL if name == "m" else K2_ATOL + K2_RTOL * r.abs()
        if not bool((dlt <= tol).all()):
            raise AssertionError(f"K2 {name} differs from plain by "
                                 f"{dlt.max().item()}: {what}")


def check_split_groups(dev, err):
    """(a): every shape of TP_SPLIT_SHAPES in f32 and bf16, windows None
    and 64, at the first, a middle and the last tp rank's heads (the
    middle one in the second half of its group): ``split_group_case``."""
    import torch
    cases = []
    for arch, d, g, hls in TP_SPLIT_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x = kernel_case(41, dtype, dev, g=g, d=d)
            for hl in hls:
                tp = HKV * g // hl
                for index in sorted({0, tp // 2 + 1, tp - 1}):
                    for window in (None, 64):
                        what = (f"{arch} {dtype} D {d} G {g} heads "
                                f"[{index * hl}, {(index + 1) * hl}) "
                                f"window {window}")
                        split_group_case(x, hl, index * hl, window, err,
                                         what)
                        cases.append(what)
    return cases


class TwoRankOrder:
    """One card's whole weights computed in the pieces of the split form's
    two tensor-parallel ranks (tp 2, the heads, KV heads and experts
    split in halves): the q/k/v projections, the decode attention (K4)
    and the unembedding on each half of the columns or heads, the
    attention's ``wo`` product as its two halves' products added, the
    experts' SwiGLU on each half of the experts, and each MoE block's
    output as the two ranks' partials added, each one ``moe._combine``
    itself over its half of the experts and of the shared expert's
    columns.  The values are the whole model's; only the shapes of the
    products and the order of the sums change, to those of the ranks."""

    def __enter__(self):
        from repro_torch.kernels.paged_decode import flash_ops
        from repro_torch.models import layers, moe
        from repro_torch.parallel import mesh_ctx
        patches = [(layers, "qkv_projections", self._qkv),
                   (layers, "attention_out", self._attention_out),
                   (layers, "unembed", self._unembed),
                   (flash_ops, "decode_attention", self._decode),
                   (moe, "_experts", self._experts),
                   (moe, "_combine", self._combine),
                   (mesh_ctx, "tp_index", lambda: self.rank),
                   (mesh_ctx, "tp_sum", lambda x: x)]
        self.saved = [(mod, name, getattr(mod, name))
                      for mod, name, _ in patches]
        self.orig = {name: fn for _, name, fn in self.saved}
        self.rank = 0
        for mod, name, fn in patches:
            setattr(mod, name, fn)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)

    @staticmethod
    def _halves(n: int):
        return [slice(r * (n // 2), (r + 1) * (n // 2)) for r in range(2)]

    def _qkv(self, cfg, p, x):
        import torch
        outs = []
        for name in "qkv":
            w = p["w" + name]
            parts = [x @ w[:, c].contiguous() for c in self._halves(w.shape[1])]
            if cfg.qkv_bias:
                parts = [y + p["b" + name][c] for y, c in
                         zip(parts, self._halves(w.shape[1]))]
            outs.append(torch.cat(parts, -1))
        return tuple(outs)

    def _attention_out(self, cfg, p, out):
        wo = p["wo"]
        a, b = (out[..., c].contiguous() @ wo[c]
                for c in self._halves(wo.shape[0]))
        return a + b

    def _unembed(self, cfg, p, x):
        import torch
        if cfg.tie_embeddings:
            tok = p["tok"]
            return torch.cat([x @ tok[c].T for c in self._halves(
                tok.shape[0])], -1)
        head = p["head"]
        return torch.cat([x @ head[:, c].contiguous() for c in self._halves(
            head.shape[1])], -1)

    def _decode(self, q, k, v, lengths, **kw):
        import torch
        return torch.cat([self.orig["decode_attention"](
            q[:, cq].contiguous(), k[:, ck].contiguous(),
            v[:, ck].contiguous(), lengths, **kw)
            for cq, ck in zip(self._halves(q.shape[1]),
                              self._halves(k.shape[1]))], 1)

    def _experts(self, cfg, p, buf):
        import torch
        outs = []
        for r, ex in enumerate(self._halves(cfg.n_experts)):
            self.rank = r
            outs.append(self.orig["_experts"](
                cfg, {k: p[k][ex] for k in ("w_gate", "w_up", "w_down")},
                buf))
        return torch.cat(outs)

    def _combine(self, cfg, p, xt, out_buf, flat_e, pos, keep, weights):
        parts = []
        for r, (ex, cols) in enumerate(zip(
                self._halves(cfg.n_experts),
                self._halves(p["shared"]["w_down"].shape[0]))):
            self.rank = r
            shared = {"w_gate": p["shared"]["w_gate"][:, cols].contiguous(),
                      "w_up": p["shared"]["w_up"][:, cols].contiguous(),
                      "w_down": p["shared"]["w_down"][cols]}
            rank_p = {"w_gate": p["w_gate"][ex], "w_down": p["w_down"][ex],
                      "shared": shared, "shared_gate": p["shared_gate"]}
            parts.append(self.orig["_combine"](
                cfg, rank_p, xt, out_buf[ex], flat_e, pos, keep, weights))
        return parts[0] + parts[1]


def batch_logits(model, toks, steps: int, attn_impl: str = "pallas"):
    """The batch layout with the kernels (attn_impl "pallas"): prefill of
    ``toks[:, :S]`` (K3), then ``steps`` decode steps of the next tokens,
    teacher-forced (K1 with its write off, K4); with ``attn_impl="ref"``
    the same on the plain paths.  Returns (the f32 logits of the prefill
    and of every step over the real vocab, [1 + steps, B, V] on the host;
    the collectives of the prefill and of the decode steps under a mesh
    context)."""
    import torch
    from repro_torch.parallel import mesh_ctx
    cfg = dataclasses.replace(model.cfg, kv_layout="batch",
                              attn_impl=attn_impl)
    m = model.with_config(cfg)
    b, s = toks.shape[0], toks.shape[1] - steps
    mesh_ctx.reset_calls()
    logits, cache = m.prefill({"tokens": toks[:, :s]}, max_len=s + steps)
    calls = {"prefill": dict(mesh_ctx.CALLS)}
    out = [logits[:, :cfg.vocab_size].cpu()]
    mesh_ctx.reset_calls()
    for k in range(steps):
        lengths = torch.full((b,), s + k + 1, dtype=torch.int32,
                             device=toks.device)
        logits, cache = m.decode_step(toks[:, s + k:s + k + 1], cache,
                                      lengths)
        out.append(logits[:, :cfg.vocab_size].cpu())
    calls["decode"] = dict(mesh_ctx.CALLS)
    return torch.stack(out).numpy(), calls


def f32_model(cfg, dev, split: bool = False):
    """``cfg``'s weights drawn in bf16 from seed 0 on ``dev`` and held in
    f32 (the same values on one card and on every rank): the whole model,
    or with ``split`` this rank's split form, the ranks drawing one after
    another so that one whole bf16 draw is on the card at a time."""
    import torch
    import torch.distributed as dist
    from repro_torch.models.model import Model
    cfg16 = dataclasses.replace(cfg, param_dtype="bfloat16",
                                compute_dtype="bfloat16")
    model = None
    for r in range(dist.get_world_size() if split else 1):
        if not split or r == dist.get_rank():
            model = Model(cfg16, device=dev, seed=0)
            if split:
                model = model.shard()     # the whole draw is dropped here
            torch.cuda.empty_cache()
        if split:
            dist.barrier()
    with torch.no_grad():
        for p in model.params.parameters():
            p.data = p.data.float()
    model.cfg = dataclasses.replace(cfg16, param_dtype="float32",
                                    compute_dtype="float32")
    torch.cuda.empty_cache()
    return model


def weight_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.params.parameters())


def tp_counts():
    """K1-K4's launch counts and the collectives since the last reset."""
    from repro_torch.kernels.flash_attention import kernel as K3
    from repro_torch.kernels.paged_decode import flash as K4
    from repro_torch.kernels.paged_decode import kernel as K
    from repro_torch.parallel import mesh_ctx
    return ({**K.LAUNCHES, **{k: v for k, v in K3.LAUNCHES.items()
                              if k == "flash_attention"}, **K4.LAUNCHES},
            dict(mesh_ctx.CALLS))


def tp_reset():
    from repro_torch.kernels.flash_attention import kernel as K3
    from repro_torch.kernels.paged_decode import flash as K4
    from repro_torch.kernels.paged_decode import kernel as K
    from repro_torch.parallel import mesh_ctx
    for mod in (K, K3, K4):
        mod.reset_launch_counts()
    mesh_ctx.reset_calls()


def moe_toks(dev):
    import torch
    b, s = TP_MOE_BATCH
    rng = np.random.default_rng(43)
    return torch.tensor(rng.integers(0, moe_cfg().vocab_size,
                                     (b, s + TP_MOE_STEPS)), device=dev)


def tp_toks(dev):
    import torch
    b, s = TP_BATCH
    rng = np.random.default_rng(47)
    return torch.tensor(rng.integers(0, full_cfg("float32").vocab_size,
                                     (b, s + TP_STEPS)), device=dev)


def tp_serve_cfg():
    """(b)'s served model: qwen3-0.6b in f32 at CUT_LAYERS's depth (every
    collective of a step is a host round trip through gloo, 5 a layer),
    on the serve phase's pool."""
    return full_cfg("float32", kv_pool_pages=SERVE_POOL,
                    n_layers=CUT_LAYERS["qwen3-0.6b"])


def moe_cfg():
    return dataclasses.replace(arch_cfg(TP_MOE), kv_layout="batch",
                               attn_impl="pallas")


def tp_rank(rank: int, workdir: str, device: str) -> None:
    """One of the TP_WORLD processes of phase tp_serve: a gloo group over a
    ``file://`` store in ``workdir``, the (1, 2) mesh context, and on the
    card (b) qwen3-0.6b's split form in f32 serving TP_TRACE on the pooled
    layout (K1, K2) at CUT_LAYERS's depth and at full depth the batch
    layout's prefill (K3) and teacher-forced decode steps (K1 write off,
    K4), then in bf16 one profiled pooled decode step; (c) the MoE arch's
    split form with the one card's expert choices pinned, then with their
    weights too (TP_MOE_PINS).  Saves what it saw as ``rank<r>.pkl``; the
    group is destroyed at the end."""
    import pickle
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_process_group, make_mesh
    from repro_torch.models.model import Model
    from repro_torch.parallel import mesh_ctx
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    torch.cuda.set_device(dev.index or 0)
    init_process_group("cpu", rank=rank, world_size=TP_WORLD,
                       init_method=f"file://{workdir}/store")
    out = {"rank": rank}
    try:
        with open(os.path.join(workdir, "routing.pkl"), "rb") as f:
            routing = pickle.load(f)
        out["backend"] = dist.get_backend()
        mesh_ctx.set_context(make_mesh((1, TP_WORLD), ("data", "model"),
                                       "cpu"))
        cfg = tp_serve_cfg()
        t = time.monotonic()
        tp_reset()
        outputs, stats, _ = serve_model(
            dev, cfg, SERVE_ENGINE, TP_TRACE,
            model=Model(cfg, device=dev, seed=0).shard())
        launches, calls = tp_counts()
        out["serve"] = {"outputs": outputs, "serve_s": time.monotonic() - t,
                        "decode_steps": stats["decode_steps"],
                        "swapped": stats["swapped"],
                        "telemetry": stats["telemetry"],
                        "launches": launches, "collectives": calls}
        t = time.monotonic()
        model = Model(full_cfg("float32"), device=dev, seed=0).shard()
        torch.cuda.empty_cache()
        out["shard"] = model.tp_shard
        out["weight_bytes_f32"] = weight_bytes(model)
        tp_reset()
        out["batch"], out["batch_calls"] = batch_logits(model, tp_toks(dev),
                                                        TP_STEPS)
        out["batch_launches"] = tp_counts()[0]
        del model
        torch.cuda.empty_cache()
        laps = out["laps_s"] = {"batch": time.monotonic() - t}
        t = time.monotonic()
        m16 = Model(full_cfg("bfloat16"), device=dev, seed=0).shard()
        torch.cuda.empty_cache()
        out["weight_bytes_bf16"] = weight_bytes(m16)
        out["step_bf16"] = mesh_step(dev, m16, TP_PROFILE_STEPS)
        del m16
        torch.cuda.empty_cache()
        laps["bf16_step"] = time.monotonic() - t
        t = time.monotonic()
        moe = f32_model(moe_cfg(), dev, split=True)
        out["moe_weight_bytes_f32"] = weight_bytes(moe)
        out["moe"], out["moe_flips"] = {}, {}
        tp_reset()
        laps["moe_draw"] = time.monotonic() - t
        for mode in TP_MOE_PINS:
            t = time.monotonic()
            pin = PinnedRouting()
            pin.ids = [i.to(dev) for i, _ in routing]
            pin.weights = [w.to(dev) for _, w in routing]
            with pin:
                pin.start(mode)
                out["moe"][mode], out["moe_calls"] = batch_logits(
                    moe, moe_toks(dev), TP_MOE_STEPS)
            out["moe_flips"][mode] = f"{pin.flips}/{pin.routed}"
            laps[f"moe_{mode}"] = time.monotonic() - t
        out["moe_launches"] = tp_counts()[0]
        del moe
        torch.cuda.empty_cache()
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        mesh_ctx.clear_context()
        mesh_ctx.forget_groups()
        dist.destroy_process_group()


def logits_close(got, want, what: str, failed: list,
                 rtol: float = TP_LOGIT_RTOL) -> dict:
    """``got`` within ``rtol`` * max |want| + TP_LOGIT_ATOL of ``want`` at
    every step, or ``what`` goes to ``failed``; returns the readings, the
    relative error of each step among them."""
    scale = np.abs(want).max()
    diff = np.abs(got - want)
    rel = float(diff.max() / scale)
    if not np.isfinite(got).all() or diff.max() > rtol * scale \
            + TP_LOGIT_ATOL:
        failed.append(f"{what}: split form against one card max |diff| "
                      f"{diff.max()} = {rel} of max |logit| {scale} > {rtol}")
    agree = (got.argmax(-1) == want.argmax(-1)).mean()
    return {"max_abs_diff": float(diff.max()), "max_abs_logit": float(scale),
            "rel": rel, "rtol": rtol, "argmax_agree": float(agree),
            "rel_by_step": [float(d.max() / scale) for d in diff]}


def phase_tp_serve(dev):
    """Tensor-parallel serving (``Model.shard``) on the card: (a) K1 + K2
    on shards whose query heads lie inside one KV-head group
    (``check_split_groups``); (b) qwen3-0.6b at full width over TP_WORLD
    processes on the one card (gloo, a (1, 2) mesh, tp 2), each holding
    its half of the heads, MLP columns and vocab: in f32 the pooled
    trace's greedy tokens (at CUT_LAYERS's depth) equal the one-card
    engine's and the batch layout's prefill and teacher-forced decode
    logits (full depth) are within TP_LOGIT_RTOL of one card's; every
    rank's the same; per-rank weight bytes (f32, bf16), collectives per
    decode step, K1-K4 launches, one bf16 pooled step's wall and device ms
    per rank beside one card's; (c) the MoE arch in the split form with
    the one card's expert choices pinned, its logits against the one card
    summing in the two ranks' order (TwoRankOrder), and with their
    weights pinned too, against the one card itself: each within
    TP_LOGIT_RTOL or, where larger, ORDER_FACTOR times one card's own
    disagreement between its kernels' and its plain attention under the
    same pinning; beside them the split form against the one card with
    the choices alone pinned, the one card's own disagreement across the
    two orders, and the router's largest |score|.  Returns ({kernel:
    launches on the split form's paths, both ranks}, the max errors of
    (a), results)."""
    import pickle
    import shutil
    import torch
    import torch.multiprocessing as mp
    from repro_torch.models.model import Model
    res, err = {"card": card()}, {"k2": 0.0}
    torch.cuda.empty_cache()
    res["allocated_gb_at_start"] = torch.cuda.memory_allocated() / 1e9
    t = time.monotonic()
    res["split_group_cases"] = len(check_split_groups(dev, err))
    res["split_group_s"] = time.monotonic() - t
    # one card's results, f32 (and a bf16 step)
    t = time.monotonic()
    one_tokens, one_stats, one_s = serve_model(dev, tp_serve_cfg(),
                                               SERVE_ENGINE, TP_TRACE)
    model = Model(full_cfg("float32"), device=dev, seed=0)
    one_batch, _ = batch_logits(model, tp_toks(dev), TP_STEPS)
    res["one_card_weight_bytes_f32"] = weight_bytes(model)
    del model
    m16 = Model(full_cfg("bfloat16"), device=dev, seed=0)
    res["one_card_weight_bytes_bf16"] = weight_bytes(m16)
    res["one_card_step_bf16"] = mesh_step(dev, m16, TP_PROFILE_STEPS)
    del m16
    torch.cuda.empty_cache()
    laps = res["one_card_laps_s"] = {"qwen3": time.monotonic() - t}
    t0 = time.monotonic()
    moe = f32_model(moe_cfg(), dev)
    laps["moe_draw"] = time.monotonic() - t0
    pin, plain_moe = PinnedRouting(), {}
    with pin:
        t0 = time.monotonic()
        pin.start("record")
        one_moe, _ = batch_logits(moe, moe_toks(dev), TP_MOE_STEPS)
        laps["moe_record"] = time.monotonic() - t0
        for mode in TP_MOE_PINS:
            t0 = time.monotonic()
            pin.start(mode)
            plain_moe[mode], _ = batch_logits(moe, moe_toks(dev),
                                              TP_MOE_STEPS, attn_impl="ref")
            laps[f"moe_plain_{mode}"] = time.monotonic() - t0
        t0 = time.monotonic()
        pin.start("replay")
        with TwoRankOrder():
            two_order_moe, _ = batch_logits(moe, moe_toks(dev), TP_MOE_STEPS)
        laps["moe_two_order"] = time.monotonic() - t0
    routing = [(i.cpu(), w.cpu()) for i, w in zip(pin.ids, pin.weights)]
    res["moe_router_score_max"] = pin.score_max.item()
    res["moe_one_card_weight_bytes_f32"] = weight_bytes(moe)
    del moe, pin
    torch.cuda.empty_cache()
    res["one_card_s"] = time.monotonic() - t
    # the ranks
    t = time.monotonic()
    workdir = os.path.join(ROOT, "build", f"tp_serve_{os.getpid()}")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    with open(os.path.join(workdir, "routing.pkl"), "wb") as f:
        pickle.dump(routing, f)
    handle = mp.start_processes(tp_rank, args=(workdir, str(dev)),
                                nprocs=TP_WORLD,
                                join=False, start_method="spawn")
    deadline = time.monotonic() + TP_TIMEOUT
    try:
        while not handle.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                raise AssertionError("phase tp_serve's ranks outlived "
                                     f"{TP_TIMEOUT} s")
    finally:
        for p in handle.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    ranks = []
    for r in range(TP_WORLD):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    shutil.rmtree(workdir, ignore_errors=True)
    res["ranks_s"] = time.monotonic() - t
    # (b) and (c) against one card
    r0, failed = ranks[0], []
    cfg = full_cfg("float32")
    layers = cfg.n_layers
    for o in ranks:
        if o["serve"]["outputs"] != one_tokens:
            bad = sorted(u for u in one_tokens
                         if one_tokens[u] != o["serve"]["outputs"].get(u))
            failed.append(f"rank {o['rank']}: split-form tokens differ from "
                          f"one card's for {bad}")
        if o["serve"]["telemetry"] != one_stats["telemetry"]:
            failed.append(f"rank {o['rank']}: telemetry differs")
        for key, a, b in [("batch", o["batch"], r0["batch"])] + [
                (f"moe {m}", o["moe"][m], r0["moe"][m]) for m in TP_MOE_PINS]:
            if not np.array_equal(a, b):
                failed.append(f"{key} logits differ between ranks")
    res["batch"] = logits_close(r0["batch"], one_batch, "qwen3-0.6b batch",
                                failed)
    # the MoE arch's own disagreement across two summation orders (the
    # kernels' attention against the plain one, the same pinning) bounds
    # each gate from below, as in phase archs.  With the choices alone
    # pinned the split form is held to the one card summing in its order;
    # with their weights pinned too, to the one card itself
    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())
    res["moe"] = {}
    for mode, want in (("replay", two_order_moe), ("replay_weights",
                                                   one_moe)):
        order = rel(plain_moe[mode], one_moe)
        res["moe"][mode] = logits_close(
            r0["moe"][mode], want, f"{TP_MOE} {mode}", failed,
            rtol=max(TP_LOGIT_RTOL, ORDER_FACTOR * order))
        res["moe"][mode].update(reordered_rel=order,
                                routing_flips=r0["moe_flips"][mode])
    res["moe"]["replay"].update(
        split_vs_one_card_rel=rel(r0["moe"]["replay"], one_moe),
        two_rank_order_vs_one_card_rel=rel(two_order_moe, one_moe))
    steps = r0["serve"]["decode_steps"]
    per_step = {k: v / steps for k, v in r0["serve"]["collectives"].items()}
    batch_step = {k: v / TP_STEPS for k, v in r0["batch_calls"]["decode"]
                  .items()}
    if sum(batch_step.values()) != 2 * layers + 2:
        failed.append(f"batch decode step collectives {batch_step}, not 2 a "
                      "layer plus 2")
    launches = {}
    for o in ranks:
        cut = tp_serve_cfg().n_layers
        want = {"paged_kv_write": cut * steps,
                "paged_gather_attend": cut * steps}
        if {k: o["serve"]["launches"][k] for k in want} != want:
            failed.append(f"rank {o['rank']} serve launches "
                          f"{o['serve']['launches']}")
        b = o["batch_launches"]
        if b["flash_attention"] != layers or \
                b["flash_decode"] != layers * TP_STEPS or \
                b["paged_kv_write"] != layers * TP_STEPS:
            failed.append(f"rank {o['rank']} batch launches {b}")
        for src in (o["serve"]["launches"], b, o["moe_launches"]):
            for k, n in src.items():
                launches[k] = launches.get(k, 0) + n
    res.update(
        serve={"requests": len(one_tokens), "decode_steps": steps,
               "reduced": reduced("qwen3-0.6b"),
               "one_card_decode_steps": one_stats["decode_steps"],
               "one_card_serve_s": one_s,
               "rank_serve_s": [o["serve"]["serve_s"] for o in ranks],
               "collectives_per_step": per_step},
        batch_collectives_per_step=batch_step,
        batch_prefill_collectives=r0["batch_calls"]["prefill"],
        moe_collectives_per_step={k: v / TP_MOE_STEPS for k, v in
                                  r0["moe_calls"]["decode"].items()},
        weight_bytes={"f32": [o["weight_bytes_f32"] for o in ranks],
                      "bf16": [o["weight_bytes_bf16"] for o in ranks],
                      "moe_f32": [o["moe_weight_bytes_f32"] for o in ranks]},
        step_bf16=[{k: o["step_bf16"][k] for k in (
            "wall_ms", "device_ms", "device_ops", "collectives")}
            for o in ranks],
        backend=r0["backend"], launches=launches,
        rank_laps_s=[o["laps_s"] for o in ranks])
    print(f"tp_serve ({res['card']}): per-rank weights "
          f"{res['weight_bytes']['bf16']} B bf16 (one card "
          f"{res['one_card_weight_bytes_bf16']}); collectives a decode step: "
          f"pooled {per_step}, batch {batch_step}; bf16 pooled step per rank "
          f"wall / device ms {[(s['wall_ms'], s['device_ms']) for s in res['step_bf16']]}"
          f" (one card {res['one_card_step_bf16']['wall_ms']} / "
          f"{res['one_card_step_bf16']['device_ms']}); K1-K4 launches "
          f"{launches}", flush=True)
    if failed:
        emit({"phase": "tp_serve", "failed": failed, **res})
        raise AssertionError(f"phase tp_serve failed: {failed}")
    return launches, err, res


# -- main -----------------------------------------------------------------------

PHASES = ("build,kernels,teacher,profile,serve,tokens,flash,prefill,batch,"
          "ssd,ssm_prefill,ssm_serve,gather,emem,vm,mesh,vm_bench,archs,"
          "encdec,train,mesh_train,paper,dryrun,tp_serve")
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
    ap.add_argument("--archs", default=",".join(ARCHS_LAYERS),
                    help="comma-separated subset of phase archs' archs")
    ap.add_argument("--log", default=None,
                    help="also append every JSON line to this file")
    args = ap.parse_args(argv)
    global LOG_PATH
    LOG_PATH = args.log
    if LOG_PATH:
        os.makedirs(os.path.dirname(os.path.abspath(LOG_PATH)), exist_ok=True)
    phases = set(args.phases.split(","))
    # deterministic cuBLAS for phase train's bit-equal resume; set before
    # torch first loads cuBLAS
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    if "mesh" in phases:
        t = time.monotonic()
        mesh_launches, res = phase_mesh(dev)
        for name, n in mesh_launches.items():
            launches[name] += n
        emit({"phase": "mesh", "seconds": time.monotonic() - t,
              "launches": mesh_launches, **res})
    if "vm_bench" in phases:
        t = time.monotonic()
        bench_launches, res = phase_vm_bench(dev)
        for name, n in bench_launches.items():
            launches[name] += n
        emit({"phase": "vm_bench", "seconds": time.monotonic() - t,
              "launches": bench_launches, **res})
    if "archs" in phases:
        failed = []
        for arch in args.archs.split(","):
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
    if "encdec" in phases:
        t = time.monotonic()
        enc_launches, res = phase_encdec(dev)
        for name, n in enc_launches.items():
            launches[name] += n
        emit({"phase": "encdec", "seconds": time.monotonic() - t, **res})
    if "train" in phases:
        run("train", phase_train, dev)
    if "mesh_train" in phases:
        run("mesh_train", phase_mesh_train, dev)
    if "paper" in phases:
        run("paper", phase_paper, dev)
    if "dryrun" in phases:
        run("dryrun", phase_dryrun, dev)
    if "tp_serve" in phases:
        t = time.monotonic()
        tp_launches, e, res = phase_tp_serve(dev)
        err["k2"] = max(err.get("k2", 0.0), e["k2"])
        for name, n in tp_launches.items():
            launches[name] += n
        emit({"phase": "tp_serve", "seconds": time.monotonic() - t,
              "max_abs_err": e, **res})

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
    print(card(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
