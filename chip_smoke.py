#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Builds the port's CUDA kernels from ``src/repro_torch`` and drives the
port's main serving path at the full width of qwen3-0.6b (random weights
from a seed), in five phases and a profile, each printing one JSON line
with its seconds:

1. build      -- nvcc builds the paged-decode kernels (K1 paged_kv_write,
                 K2 paged_gather_attend) from the checkout's sources;
2. kernels    -- each kernel against its plain PyTorch version (the
                 composed oracle, ``kernels/paged_decode/ref.py``) at the
                 main path's shapes (f32 and bf16, 1 and 2 emulated shards,
                 window None and 64) and at other head groups, head dims
                 and page sizes, with kernel / plain / library times and
                 the least time the card could take (bound);
3. teacher    -- 64 teacher-forced full-width decode steps with the kernels
                 and with the composed oracle, same weights and tokens:
                 logits agree within the stated tolerance (f32 and bf16);
   profile    -- where a full-width bf16 decode step's time goes: wall ms
                 per step, and device ms per step by kernel (torch.profiler);
4. serve      -- the full-width engine + scheduler serve a seeded trace in
                 bf16; every request completes, shutdown is leak-free, a
                 swap preemption and prefix sharing happen, and every decode
                 step of every layer launched both kernels;
5. tokens     -- the same trace in f32 gives identical per-uid tokens with
                 the kernels and with the composed oracle.

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

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
F32_FLOPS_PER_S = 67e12            # H100 SXM float32 outside the tensor cores

# phase 2 shapes: the main path's (qwen3-0.6b: 8 KV heads of 128, 2 query
# heads per KV head; 16-slot pages; 8 slots x 512 tokens of table)
B, HKV, G, D, PS, MAX_LP = 8, 8, 2, 128, 16, 32
# tolerances, kernel against plain (both compute in f32 from the same
# inputs, summing in another order): pages byte-equal; acc and l within
# rtol 1e-5 + atol 1e-5; m (a max of q.k products) within atol 1e-5
K2_RTOL, K2_ATOL, M_ATOL = 1e-5, 1e-5, 1e-5
# teacher-forced logits, kernels against composed, relative to max |logit|
# over the run: f32 1e-3, which with phase 2 carries correctness; bf16
# 5e-2, a smoke check of the bf16 path only (one bf16 rounding of an
# attention output that lands on the other side of a tie moves a logit by
# ~2^-8 of its size, and 28 layers and 64 steps of cache carry it on)
LOGIT_RTOL = {"float32": 1e-3, "bfloat16": 5e-2}

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


def timed(fn, iters: int = 50) -> dict:
    """Both clocks for one function: the profiler's device time per call
    and the CUDA-event time per call of a loop of calls (which is the
    Python wrapper's time when a call is shorter than its wrapper)."""
    dev_ms, _ = device_profile(fn, iters=min(iters, 20))
    return {"device_ms": dev_ms, "loop_ms": cuda_ms(fn, iters=iters)}


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

def kernel_case(seed, dtype, dev, g=G, d=D, ps=PS, max_lp=MAX_LP):
    import torch
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, max_lp * ps + 1, B).astype(np.int32)
    lengths[1], lengths[2] = 0, min(7, ps)   # an empty row; a write to page 0
    bt, fl, fr = mk_vm(rng, B, max_lp, ps, lengths, shared_page0=True)
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


def k1_bytes(x, n_shards, sid):
    """Bytes K1 moves on these inputs: each row's length and write-mask
    flag; for a row that passes those, its block-table word and, for a
    mapped frame, that frame's read-only flag; for a row it writes, the new
    K and V rows read and written."""
    es_in, es_kv = x["k_new"].element_size(), x["kp"].element_size()
    row = HKV * D
    n_frames = len(x["fr_np"])
    nbytes = B * (4 + 1)
    for b in range(B):
        ln = int(x["lengths_np"][b])
        if not x["wm_np"][b] or ln <= 0 or (ln - 1) // PS >= MAX_LP:
            continue
        nbytes += 4
        f = int(x["bt_np"][b, (ln - 1) // PS])
        if not 0 <= f < n_frames:
            continue
        nbytes += 1
        if not x["fr_np"][f] and f % n_shards == sid:
            nbytes += 2 * row * (es_in + es_kv)
    return nbytes


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
    """Both kernels (``ops.paged_decode_shard``'s fused impl) against their
    plain versions (its composed impl) on one emulated shard: pages
    byte-equal, (acc, m, l) within the stated tolerance.  Raises on a
    mismatch, folds max errors into ``err``; returns the fused outputs."""
    import torch
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


def check_case(x, n_shards, window, err):
    """Every emulated shard of one input set; row 1 is empty and must come
    out exactly (acc, m, l) = (0, -1e30, 0)."""
    what = (f"{x['kp'].dtype} G={x['group']} D={x['q'].shape[2]} "
            f"slots={x['kp'].shape[1]} S={n_shards} window={window}")
    for sid in range(n_shards):
        acc, m, l = (o[1] for o in check_shard(x, sid, n_shards, window, True,
                                               err, what)[:3])
        if not (bool((m == -1e30).all()) and bool((l == 0).all())
                and bool((acc == 0).all())):
            raise AssertionError(f"K2: empty row is not (-1e30, 0, 0): {what}")


#: other head groups, head dims and page sizes the kernels take: (G, D,
#: page_slots, max_lpages), each in f32 and bf16, windows None and 5
OTHER_SHAPES = [(1, 64, 4, 16), (3, 80, 8, 8), (4, 256, 256, 2),
                (16, 32, 16, 4)]


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
    err = {"k1": 0.0, "k2": 0.0}
    timing = {}
    for dtype in (torch.float32, torch.bfloat16):
        for n_shards in (1, 2):
            for window in (None, 64):
                x = kernel_case(17, dtype, dev)
                check_case(x, n_shards, window, err)
                if dtype == torch.bfloat16 and n_shards == 1 and window is None:
                    timing = time_kernels(x)
        for g, d, ps, max_lp in OTHER_SHAPES:
            x = kernel_case(23, dtype, dev, g=g, d=d, ps=ps, max_lp=max_lp)
            for window in (None, 5):
                check_case(x, 1, window, err)
    check_identity_tables(dev, err)
    return err, timing


def time_kernels(x):
    """Kernel, plain and library times at the main path's shapes (bf16, one
    shard, no window).  K2 cycles over 8 copies of the page pool (8 x 17 MB,
    past the 50 MB L2), since the serving path finds each layer's pages cold."""
    import torch
    from repro_torch.kernels.paged_decode import kernel as K
    from repro_torch.kernels.paged_decode import ref
    meta = (0, 1, 0)
    shard = dict(sid=0, n_shards=1, max_pages=MAX_LP)
    kp, vp = x["kp"].clone(), x["vp"].clone()
    out = {}
    out["k1"] = timed(lambda: K.paged_kv_write(
        x["k_new"], x["v_new"], kp, vp, x["bt"], x["lengths"], x["fr"],
        x["wm"], meta))
    out["k1_plain"] = timed(lambda: ref.write_kv(
        x["k_new"], x["v_new"], kp, vp, x["lengths"], x["bt"], x["fr"],
        x["wm"], **shard))
    # library: index_put_ of the precomputed (row, slot) targets, K and V
    ln = x["lengths_np"]
    sel = [b for b in range(B) if x["wm_np"][b] and ln[b] > 0
           and not x["fr_np"][x["bt_np"][b, (ln[b] - 1) // PS]]]
    rows = torch.tensor([int(x["bt_np"][b, (ln[b] - 1) // PS]) for b in sel],
                        device=kp.device)
    offs = torch.tensor([int((ln[b] - 1) % PS) for b in sel], device=kp.device)
    bsel = torch.tensor(sel, device=kp.device)
    k_rows, v_rows = x["k_new"][bsel], x["v_new"][bsel]

    def library():
        kp.index_put_((rows, offs), k_rows)
        vp.index_put_((rows, offs), v_rows)
    out["k1_library"] = timed(library)
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
    b1 = k1_bytes(x, 1, 0)
    b2, ops2 = k2_work(x, 1, 0, None)
    out["k1_bound_ms"] = b1 / HBM_BYTES_PER_S * 1e3
    out["k2_bound_ms"] = max(b2 / HBM_BYTES_PER_S, ops2 / F32_FLOPS_PER_S) * 1e3
    out["k2_bound_by"] = ("bytes" if b2 / HBM_BYTES_PER_S
                          >= ops2 / F32_FLOPS_PER_S else "operations")
    out["k1_bytes"], out["k2_bytes"], out["k2_ops"] = b1, b2, ops2
    return out


# -- phase 3 -------------------------------------------------------------------

def full_cfg(dtype: str, **kw):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("qwen3-0.6b"), kv_layout="pooled",
                               kv_page_slots=16, param_dtype=dtype,
                               compute_dtype=dtype, **kw)


def phase_teacher(dev, dtype: str, steps: int = 64):
    """Teacher-forced decode with the kernels and with the composed oracle
    on the same weights, tokens and tables; sequences start staggered (4
    steps apart) and two share a read-only page-0 frame."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.models.model import Model
    cfg = full_cfg(dtype)
    model = Model(cfg, device=dev, seed=0)
    rng = np.random.default_rng(3)
    max_lp = -(-steps // 16)
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
    for impl in ("auto", "composed"):
        c = T.init_cache(dataclasses.replace(cfg, kv_pool_pages=n_frames),
                         B, steps, dev)
        g = torch.Generator(device=dev).manual_seed(1)
        for name in ("k_pages", "v_pages"):   # the shared frame's content
            c["b0"][name][:, shared] = torch.randn(
                c["b0"][name][:, shared].shape, generator=g, device=dev
            ).to(c["b0"][name].dtype)
        c["vm"] = {"block_table": torch.tensor(bt, device=dev),
                   "frame_lpage": torch.tensor(fl, device=dev),
                   "frame_ro": torch.tensor(fr, device=dev)}
        caches[impl] = c
    start = np.arange(B) * 4
    toks = rng.integers(0, cfg.vocab_size, (steps + int(start[-1]), B))
    max_diff = max_ref = early_diff = 0.0
    agree = total = 0
    with torch.no_grad():
        for k in range(steps + int(start[-1])):
            lengths = np.clip(k - start + 1, 0, steps).astype(np.int32)
            wm = (k >= start) & (k - start < steps)
            if not wm.any():
                continue
            tok = torch.tensor(toks[k, :, None].astype(np.int32), device=dev)
            outs = {}
            for impl, c in caches.items():
                outs[impl], _ = T.decode_step(
                    dataclasses.replace(cfg, paged_kernel=impl), model.params,
                    tok, c, torch.tensor(lengths, device=dev),
                    torch.tensor(wm, device=dev), periods=model.periods())
            live = torch.tensor(wm, device=dev)
            a, r = outs["auto"][live], outs["composed"][live]
            max_diff = max(max_diff, (a - r).abs().max().item())
            max_ref = max(max_ref, r.abs().max().item())
            if k < 8:                  # before cache differences build up
                early_diff = max_diff
            agree += int((a.argmax(-1) == r.argmax(-1)).sum().item())
            total += int(live.sum().item())
    rel = max_diff / max_ref
    if not np.isfinite(rel) or rel > LOGIT_RTOL[dtype]:
        raise AssertionError(f"teacher-forced logits ({dtype}): kernels vs "
                             f"composed max |diff| {max_diff} = {rel} of max "
                             f"|logit| {max_ref} > {LOGIT_RTOL[dtype]}")
    del model, caches
    torch.cuda.empty_cache()
    return {"dtype": dtype, "max_abs_diff": max_diff, "max_abs_logit": max_ref,
            "rel": rel, "rtol": LOGIT_RTOL[dtype],
            "rel_first_8_steps": early_diff / max_ref,
            "argmax_agree": f"{agree}/{total}"}


# -- phases 4 and 5 --------------------------------------------------------------

def serve(dev, dtype: str, paged_kernel: str = "auto"):
    """Replay the trace through the full-width engine; returns (per-uid
    outputs, shutdown stats, seconds)."""
    import torch
    from repro_torch.models.model import Model
    from repro_torch.serve import (EngineConfig, Scheduler, ServeEngine,
                                   TraceConfig, generate, replay)
    cfg = full_cfg(dtype, kv_pool_pages=SERVE_POOL, paged_kernel=paged_kernel)
    model = Model(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with ServeEngine(model, EngineConfig(**SERVE_ENGINE)) as eng:
        done = replay(generate(TraceConfig(**SERVE_TRACE)), Scheduler(eng))
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    stats = eng.shutdown()
    if len(done) != SERVE_TRACE["n_requests"] or not all(r.done for r in done):
        raise AssertionError(f"{len(done)} of {SERVE_TRACE['n_requests']} "
                             "requests completed")
    if stats["leaked_frames"]:
        raise AssertionError(f"leaked frames: {stats['leaked_frames']}")
    outputs = {r.uid: tuple(r.output) for r in done}
    del model, eng
    torch.cuda.empty_cache()
    return outputs, stats, dt


def phase_serve(dev):
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_decode import kernel as K
    K.reset_launch_counts()
    outputs, stats, dt = serve(dev, "bfloat16")
    launches = dict(K.LAUNCHES)
    n_layers = get_config("qwen3-0.6b").n_layers
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} was never launched on the main path")
        if n != n_layers * stats["decode_steps"]:
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
    kern, st_k, dt_k = serve(dev, "float32", "auto")
    comp, st_c, dt_c = serve(dev, "float32", "composed")
    if kern != comp:
        bad = sorted(u for u in kern if kern[u] != comp.get(u))
        raise AssertionError(f"f32 served tokens differ, kernels vs composed, "
                             f"for uids {bad}")
    if st_k["telemetry"] != st_c["telemetry"]:
        raise AssertionError("f32 telemetry differs, kernels vs composed")
    return {"requests": len(kern),
            "new_tokens": sum(len(o) for o in kern.values()),
            "kernels_s": dt_k, "composed_s": dt_c}


def phase_profile(dev, steps: int = 10):
    """Where a decode step's time goes: full-width bf16 decode of 8
    sequences at ~256 tokens over scrambled tables, each step synced to the
    host as the engine's stepwise path does.  Wall time per step (no
    profiler), then device time per step by kernel from torch.profiler."""
    import torch
    from repro_torch.models.model import Model
    from repro_torch.serve.fused_decode import sampled_decode_step
    model = Model(full_cfg("bfloat16"), device=dev, seed=0)
    cache = model.init_cache(B, MAX_LP * PS)
    rng = np.random.default_rng(5)
    start = 256
    bt, fl, fr = mk_vm(rng, B, MAX_LP, PS, [MAX_LP * PS] * B, False)
    cache["vm"] = {"block_table": torch.tensor(bt, device=dev),
                   "frame_lpage": torch.tensor(fl, device=dev),
                   "frame_ro": torch.tensor(fr, device=dev)}
    wm = torch.ones(B, dtype=torch.bool, device=dev)
    pos = itertools.count(start)

    def step():
        n = next(pos)
        lengths = torch.full((B,), n, dtype=torch.int32, device=dev)
        tok = torch.tensor(rng.integers(0, 151936, (B, 1)), dtype=torch.int32,
                           device=dev)
        sampled, _, _ = sampled_decode_step(model, tok, cache, lengths, wm)
        return sampled.cpu()

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    dev_ms, by_name = device_profile(step, iters=steps, warmup=0)
    del model, cache
    torch.cuda.empty_cache()
    out = {"wall_ms_per_step": wall_ms, "device_ms_per_step": dev_ms}
    if dev_ms is None:
        return out
    ops = by_name.pop("device_ops_per_call")
    k1 = sum(v for k, v in by_name.items() if "kv_write_kernel" in k)
    k2 = sum(v for k, v in by_name.items() if "gather_attend_kernel" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    out.update(busy_share=dev_ms / wall_ms, device_ops_per_step=ops,
               k1_ms_per_step=k1,
               k2_ms_per_step=k2,
               top_kernels_ms_per_step=[[k[:80], v] for k, v in top])
    return out


# -- main -----------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases",
                    default="build,kernels,teacher,profile,serve,tokens",
                    help="comma-separated subset of the phases to run")
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
    from repro_torch.kernels.paged_decode import kernel as K
    dev = torch.device("cuda")
    kinfo = {"launches": {n: 0 for n in K.LAUNCHES}}

    t = time.monotonic()
    path, log = K.build()
    emit({"phase": "build", "seconds": time.monotonic() - t,
          "library": os.path.relpath(path, ROOT),
          "ptxas": [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]})
    if "kernels" in phases:
        t = time.monotonic()
        err, timing = phase_kernels(dev)
        kinfo.update(err=err, timing=timing)
        emit({"phase": "kernels", "seconds": time.monotonic() - t,
              "max_abs_err": err, **timing})
    if "teacher" in phases:
        for dtype in ("float32", "bfloat16"):
            t = time.monotonic()
            res = phase_teacher(dev, dtype)
            emit({"phase": "teacher", "seconds": time.monotonic() - t, **res})
    if "profile" in phases:
        t = time.monotonic()
        res = phase_profile(dev)
        emit({"phase": "profile", "seconds": time.monotonic() - t, **res})
    if "serve" in phases:
        t = time.monotonic()
        kinfo["launches"], res = phase_serve(dev)
        emit({"phase": "serve", "seconds": time.monotonic() - t, **res})
    if "tokens" in phases:
        t = time.monotonic()
        res = phase_tokens(dev)
        emit({"phase": "tokens", "seconds": time.monotonic() - t, **res})

    tm = kinfo.get("timing", {})
    err = kinfo.get("err", {})

    def ms(key):
        # the profiler's device time; the event-timed loop where the
        # profiler saw no device activity
        t = tm.get(key)
        if t is None:
            return None
        return t["device_ms"] if t["device_ms"] is not None else t["loop_ms"]
    src = "src/repro_torch/kernels/paged_decode/csrc/paged_decode.cu"
    emit({"kernels": [
        {"name": "paged_kv_write", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/paged_decode/kernel.py:107",
         "launches": kinfo["launches"]["paged_kv_write"],
         "max_abs_err": err.get("k1"), "ms": ms("k1"),
         "plain_ms": ms("k1_plain"), "bound_ms": tm.get("k1_bound_ms"),
         "bound_by": "bytes", "library_ms": ms("k1_library")},
        {"name": "paged_gather_attend", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/paged_decode/kernel.py:211",
         "launches": kinfo["launches"]["paged_gather_attend"],
         "max_abs_err": err.get("k2"), "ms": ms("k2"),
         "plain_ms": ms("k2_plain"), "bound_ms": tm.get("k2_bound_ms"),
         "bound_by": tm.get("k2_bound_by"), "library_ms": None},
    ]})
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
