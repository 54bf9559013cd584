"""End-to-end training driver (the flags of ``repro.launch.train``, plus
``--device``):

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --smoke --steps 20 --batch 8 --seq 128 --device cpu

runs on ``cuda`` unless ``--device`` names another device.  Features
exercised: the deterministic data pipeline, init from a seed, AdamW with
master weights, microbatching, checkpoint/restore (``--ckpt-dir``),
straggler logging.  Training takes the plain paths (``attn_impl``
"chunked", the configs' default).  Prints the reference's final JSON
(``first_loss``, ``last_loss``, ``improved``, ``stragglers``).
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.data import DataConfig, SyntheticLM
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
                    help="tensor parallelism: only 1 until the port has "
                         "sharding and meshes (ROADMAP Queue 1)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.tp != 1:
        ap.error("--tp > 1 needs the port's sharding (ROADMAP Queue 1)")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = Model(cfg, device=args.device, seed=args.seed)
    print(f"arch={cfg.name} params={model.param_count():,} "
          f"device={model.device}")

    ocfg = AdamWConfig(lr=schedules.warmup_cosine(args.lr, 5, args.steps))
    tcfg = TrainConfig(microbatches=args.microbatches)
    trainer = Trainer(model, ocfg, tcfg)
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
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
