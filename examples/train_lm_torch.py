"""End-to-end training example on the PyTorch port (``repro_torch``).

Default: a ~10M-param qwen3-family model for 30 steps.  Scale to the
~100M/200-step configuration with: --d-model 512 --layers 8 --steps 200
--batch 16 --seq 512 (identical code path, longer wall time).  Runs on
``cuda`` unless ``--device`` names another device.  Under ``torchrun`` it
trains on a ``(world / tp, tp)`` ("data", "model") mesh of the ranks
(``nccl`` on ``cuda``, ``gloo`` with ``--device cpu``), each tp rank on its
split form of the model at tp > 1.

Run: PYTHONPATH=src python examples/train_lm_torch.py [--steps N]
     [--ckpt-dir D] [--device cpu]
     PYTHONPATH=src torchrun --nproc_per_node 4 examples/train_lm_torch.py
     --tp 2 --device cpu
"""
import argparse
import os
import sys

import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch.train import mesh_from_env  # noqa: E402
from repro_torch.models import Model, ModelConfig  # noqa: E402
from repro_torch.optim import AdamWConfig, schedules  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.train.fault_tolerance import StragglerDetector  # noqa: E402
from repro_torch.train.trainer import TrainConfig, Trainer  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tp", type=int, default=1,
                    help="ranks of the mesh's \"model\" axis (under "
                         "torchrun)")
    args = ap.parse_args(argv)
    dev, mesh, started = mesh_from_env(args.device, args.tp)
    try:
        return train(args, dev, mesh)
    finally:
        if started:
            dist.destroy_process_group()


def train(args, dev, mesh):
    lead = mesh is None or dist.get_rank() == 0

    cfg = ModelConfig(
        name="example-lm", family="dense", n_layers=args.layers,
        d_model=args.d_model, n_heads=max(4, args.d_model // 64),
        n_kv_heads=max(2, args.d_model // 128), head_dim=64,
        d_ff=args.d_model * 3, vocab_size=args.vocab, qk_norm=True,
        param_dtype="float32", compute_dtype="float32")
    model = Model(cfg, device=dev)
    if lead:
        print(f"params: {model.param_count():,}")

    trainer = Trainer(
        model, mesh,
        AdamWConfig(lr=schedules.warmup_cosine(3e-3, 10, args.steps)),
        TrainConfig(microbatches=args.microbatches))
    params, opt = trainer.init_state()
    data = SyntheticLM(cfg, DataConfig(args.batch, args.seq))
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    det = StragglerDetector()
    hooks = [lambda s, p, o, m: det.observe(s, m["step_time_s"])]
    if ckpt:
        hooks.append(lambda s, p, o, m: ckpt.save(s, {"params": p})
                     if s % 10 == 0 else None)
    params, opt, hist = trainer.run(params, opt, iter(data), args.steps, hooks)
    if ckpt:
        ckpt.wait()
    if lead:
        print(f"loss: {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}; "
              f"stragglers flagged: {len(det.flagged)}")
    assert hist[-1]["loss"] < hist[0]["loss"]
    return hist


if __name__ == "__main__":
    main()
