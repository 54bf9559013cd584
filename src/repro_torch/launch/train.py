"""End-to-end training driver (the flags of ``repro.launch.train``, plus
``--device``):

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --smoke --steps 20 --batch 8 --seq 128 --device cpu

runs on ``cuda`` unless ``--device`` names another device.  Started by
``torchrun`` (``RANK`` and ``WORLD_SIZE`` in the environment) it trains on a
``(world / tp, tp)`` ("data", "model") mesh over the started group, ``nccl``
on ``cuda`` and ``gloo`` only with ``--device cpu``, each tp rank computing
the step on its split form (its heads, MLP columns, experts, SSM heads and
vocab block) at tp > 1:

  PYTHONPATH=src torchrun --nproc_per_node 4 -m repro_torch.launch.train \\
      --smoke --tp 2 --device cpu

Without that environment it trains on one device and refuses ``--tp`` above
1.  Features exercised: the deterministic data pipeline, init from a seed
(each rank keeps its shards), AdamW with master weights, microbatching,
checkpoint/restore (``--ckpt-dir``), straggler logging.  Training takes the
plain paths (``attn_impl`` "chunked", the configs' default).  Prints the
reference's final JSON (``first_loss``, ``last_loss``, ``improved``,
``stragglers``), from rank 0 on a mesh.
"""
from __future__ import annotations

import argparse
import json

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch.mesh import mesh_from_env, mesh_shape
from repro_torch.models.model import Model
from repro_torch.optim import AdamWConfig, schedules
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault_tolerance import StragglerDetector
from repro_torch.train.trainer import TrainConfig, Trainer


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--device", default="cuda",
                    help="torch device the model and optimizer state live on")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1,
                    help="ranks of the mesh's \"model\" axis (under "
                         "torchrun)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev, mesh, started = mesh_from_env(args.device, args.tp)
    try:
        return _train(args, dev, mesh)
    finally:
        if started:
            dist.destroy_process_group()


def _train(args, dev, mesh) -> dict:
    lead = mesh is None or dist.get_rank() == 0
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = Model(cfg, device=dev, seed=args.seed)
    if lead:
        shape = None if mesh is None else mesh_shape(mesh)
        print(f"arch={cfg.name} params={model.param_count():,} "
              f"device={model.device} mesh={shape}")

    ocfg = AdamWConfig(lr=schedules.warmup_cosine(args.lr, 5, args.steps))
    tcfg = TrainConfig(microbatches=args.microbatches)
    trainer = Trainer(model, mesh, ocfg, tcfg)
    params, opt = trainer.init_state(args.seed)

    data = SyntheticLM(cfg, DataConfig(args.batch, args.seq, seed=args.seed))
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    straggler = StragglerDetector()

    hooks = []
    if ckpt and args.ckpt_every:
        hooks.append(lambda step, p, o, m:
                     ckpt.save(step, {"params": p, "opt": o})
                     if step % args.ckpt_every == 0 else None)
    hooks.append(lambda step, p, o, m:
                 straggler.observe(step, m["step_time_s"]))

    params, opt, history = trainer.run(params, opt, iter(data), args.steps,
                                       hooks)
    if ckpt:
        ckpt.wait()
    first, last = history[0]["loss"], history[-1]["loss"]
    report = {"first_loss": first, "last_loss": last,
              "improved": last < first, "stragglers": straggler.flagged}
    if lead:
        print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
