"""Serving example on the PyTorch port: continuous batching over the paged
(emulated-memory) KV cache, as ``examples/serve_lm.py`` does over ``repro``.
``--layout pooled`` uses the frame pool: KV pages allocated on demand and
freed at completion, so the 6 requests share a pool sized for 3 fixed
slots.  Runs on the card unless ``--device cpu``.

Run: PYTHONPATH=src python examples/serve_lm_torch.py [--layout batch|paged|pooled] [--device cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model
from repro_torch.serve import EngineConfig, Request, Scheduler, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--layout", choices=("batch", "paged", "pooled"),
                    default="paged")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; no CPU fallback)")
    args = ap.parse_args(argv)

    # pooled: 6 decode slots share the KV pool that "paged" reserves for 3
    pool = 3 * (96 // 16) if args.layout == "pooled" else None
    slots = 6 if args.layout == "pooled" else 3
    cfg = ModelConfig(name="serve-example", family="dense", n_layers=2,
                      d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
                      d_ff=256, vocab_size=256, kv_layout=args.layout,
                      kv_page_slots=16, kv_pool_pages=pool,
                      param_dtype="float32", compute_dtype="float32")
    model = Model(cfg, device=args.device, seed=0)
    # the engine is a context manager: the shutdown leak detector (every KV
    # frame refcount back to zero) runs even if the body raises
    with ServeEngine(model, EngineConfig(slots=slots, max_len=96)) as engine:
        sched = Scheduler(engine)
        rng = np.random.default_rng(0)
        reqs = [Request(uid=i,
                        prompt=rng.integers(0, 256, 8).astype(np.int32),
                        max_new_tokens=12) for i in range(args.requests)]
        sched.submit(reqs)
        t0 = time.monotonic()
        done = sched.run()
        dt = time.monotonic() - t0
        n_new = sum(len(r.output) for r in done)
        print(f"kv_layout={cfg.kv_layout}: {len(done)} requests, "
              f"{n_new} tokens in {dt:.1f}s ({n_new / dt:.1f} tok/s) "
              f"{engine.pool_stats()}")
        for r in done[:3]:
            print(f"  req {r.uid}: {list(r.prompt[:4])}... -> {r.output}")
        # per-request SLO table: every latency an exact decode-step count
        print("  uid  wait  ttft  mean_itl  tokens  preempt  shared  "
              "match_pages")
        for row in engine.metrics.request_rows():
            print(f"  {row['uid']:>3}  {row['queue_wait']:>4}  "
                  f"{row['ttft']:>4}  {row['mean_itl']!s:>8}  "
                  f"{row['tokens']:>6}  {row['preemptions']:>7}  "
                  f"{row['shared_tokens']:>6}  "
                  f"{row['match_depth_pages']:>11}")
        tel = engine.telemetry()
        print(f"  ttft p50/p95/p99 = {tel['ttft_steps']['p50']}/"
              f"{tel['ttft_steps']['p95']}/{tel['ttft_steps']['p99']} steps, "
              f"itl mean = {tel['itl_steps']['mean']} steps")
        mon = tel["monitor"]
        print(f"  monitor: median={mon['median']} spikes={mon['spikes']} "
              f"regressions={mon['regressions']} over {mon['samples']} reqs")
    print(f"shutdown: {engine.shutdown()}")


if __name__ == "__main__":
    main()
