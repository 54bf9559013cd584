"""Serving CLI: batched requests through the port's continuous-batching
engine (the flags of ``repro.launch.serve``, plus ``--device``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b

runs on ``cuda``; ``--device cpu`` runs on the CPU (use ``--smoke`` there).
``--trace`` replays a seeded synthetic trace (Poisson arrivals, Zipf prompt
popularity, bimodal lengths) against the engine's decode-step clock, so
requests genuinely queue; the JSON report then carries the per-request SLO
telemetry (TTFT, inter-token latency and queue wait, in decode steps).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.models.model import Model
from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
from repro_torch.serve.scheduler import Scheduler, SchedulerConfig
from repro_torch.serve.tracegen import TraceConfig, generate, replay


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device the model and KV pages live on")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--paged", action="store_true",
                    help="use the emulated-memory paged KV layout "
                         "(reserved tables); the default is the pooled "
                         "layout, since the port serves no batch layout yet")
    ap.add_argument("--max-fused-steps", type=int, default=8,
                    help="decode steps fused into one run between "
                         "control-plane events; 1 reproduces step-at-a-time "
                         "dispatch exactly")
    ap.add_argument("--preempt-mode", choices=("swap", "recompute"),
                    default="swap",
                    help="how preempted sequences resume: swap-in of "
                         "host-parked pages, or requeue-and-re-prefill")
    ap.add_argument("--retain-frames", type=int, default=0,
                    help="device frames the retention pool may keep holding "
                         "completed prompts' prefix pages (0 disables)")
    ap.add_argument("--prefix-index", choices=("tree", "linear"),
                    default="tree",
                    help="prompt prefix index: radix tree (O(prompt) "
                         "lookup) or the linear scan oracle")
    ap.add_argument("--host-frames", type=int, default=None,
                    help="host backing-store frames for swapped-out pages "
                         "(default: one per device frame)")
    ap.add_argument("--spill-frames", type=int, default=0,
                    help="third-tier spill-store frames the host tier "
                         "demotes into under pressure (0 disables)")
    ap.add_argument("--spill-path", type=str, default=None,
                    help="directory backing the spill store (default: "
                         "in-memory bytes)")
    ap.add_argument("--sched-window", type=int,
                    default=SchedulerConfig.window,
                    help="residency-aware admission reorder window "
                         "(1 = strict FIFO)")
    ap.add_argument("--aging-steps", type=int,
                    default=SchedulerConfig.aging_steps,
                    help="decode steps a passed-over request waits before "
                         "it outranks every admission score")
    ap.add_argument("--trace", action="store_true",
                    help="replay a seeded synthetic trace instead of "
                         "submitting every request up front")
    ap.add_argument("--trace-seed", type=int, default=0,
                    help="trace rng seed: the same seed reproduces the "
                         "schedule byte-for-byte")
    ap.add_argument("--arrival-rate", type=float, default=0.25,
                    help="mean trace arrivals per decode step")
    ap.add_argument("--zipf-alpha", type=float, default=1.2,
                    help="prompt-popularity skew (larger = hotter head)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    # f32 matmuls in full f32, as the reference computes them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(
        cfg, kv_layout="paged" if args.paged else "pooled", kv_page_slots=16)
    model = Model(cfg, device=args.device, seed=args.seed)

    engine = ServeEngine(model, EngineConfig(
        slots=args.slots, max_len=args.max_len,
        preempt_mode=args.preempt_mode, retain_frames=args.retain_frames,
        host_frames=args.host_frames, spill_frames=args.spill_frames,
        spill_path=args.spill_path,
        max_fused_steps=args.max_fused_steps,
        prefix_index=args.prefix_index))
    sched = Scheduler(engine, SchedulerConfig(window=args.sched_window,
                                              aging_steps=args.aging_steps))
    t0 = time.monotonic()
    if args.trace:
        tcfg = TraceConfig(
            seed=args.trace_seed, n_requests=args.requests,
            arrival_rate=args.arrival_rate, zipf_alpha=args.zipf_alpha,
            prompt_len_short=max(2, args.prompt_len // 2),
            prompt_len_long=args.prompt_len,
            out_len_short=max(1, args.max_new // 2),
            out_len_long=args.max_new, vocab_size=cfg.vocab_size)
        done = replay(generate(tcfg), sched)
    else:
        rng = np.random.default_rng(args.seed)
        sched.submit([Request(uid=i,
                              prompt=rng.integers(0, cfg.vocab_size,
                                                  args.prompt_len)
                              .astype(np.int32),
                              max_new_tokens=args.max_new)
                      for i in range(args.requests)])
        done = sched.run()
    dt = time.monotonic() - t0
    stats = engine.shutdown()
    total_new = sum(len(r.output) for r in done)
    print(json.dumps({
        "completed": len(done), "new_tokens": total_new,
        "tokens_per_s": round(total_new / dt, 1),
        "outputs": {r.uid: r.output[:8] for r in done},
        "telemetry": stats["telemetry"],
    }, indent=1))


if __name__ == "__main__":
    main()
