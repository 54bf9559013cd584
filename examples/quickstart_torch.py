"""Quickstart on the PyTorch port: the paper's models in a minute.

1. Analytic reproduction: emulated-memory latency + slowdown (paper Fig
   9/10), through ``repro_torch.core``.
2. Executable EMem: a logical memory on the device, written and read
   through ``write_ref`` / ``read_ref``, and the dispatch analytics.
3. A tiny LM trained for a few steps by ``Trainer(model, mesh, ...)`` on a
   ("data", "model") mesh over the process group: a one-rank group is
   started when none is running (``nccl`` on ``cuda``, ``gloo`` with
   ``--device cpu``); under ``torchrun`` the mesh spans its ranks.

As ``examples/quickstart.py`` does over ``repro``.  Runs on ``cuda``
unless ``--device cpu``.

Run: PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.device import resolve_device  # noqa: E402


def paper_models() -> dict:
    from repro_torch.core import dram, emulation, latency
    base = dram.paper_baseline(1)
    print(f"DDR3 baseline: {base:.1f} ns (paper: 35 ns)")
    lat = latency.mean_access_latency_ns("clos", 4096, 4096)
    print(f"4096-tile folded-Clos emulated access: {lat:.1f} ns "
          f"({lat / base:.2f}x DDR3; paper: 2-5x)")
    s = emulation.slowdown(emulation.DHRYSTONE, "clos", 4096, 4096)
    print(f"Dhrystone slowdown on the emulation: {s:.2f}x (paper: 2-3x)")
    return {"ddr3_ns": base, "clos_ns": lat, "dhrystone_slowdown": s}


def executable_emem(device) -> dict:
    from repro_torch.core import emem
    spec = emem.EMemSpec(n_slots=4096, width=8, page_slots=64, n_shards=1)
    mem = emem.create(spec, device=device)
    rng = np.random.default_rng(0)
    addrs = torch.tensor(rng.permutation(4096)[:128].astype(np.int32),
                         device=mem.device)
    vals = torch.tensor(rng.normal(size=(128, 8)).astype(np.float32),
                        device=mem.device)
    emem.write_ref(spec, mem, addrs, vals)
    out = emem.read_ref(spec, mem, addrs)
    err = float((out - vals).abs().max())
    print(f"EMem read-after-write max err: {err:.2e}")
    stats = emem.dispatch_stats(emem.EMemSpec(1 << 20, 128, 256, 256), 4096,
                                1.5)
    print("EMem dispatch stats @256 shards:", stats)
    return {"emem_max_err": err, "dispatch": stats}


def tiny_training(device) -> dict:
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import (init_process_group, make_host_mesh,
                                         mesh_shape)
    from repro_torch.launch.train import mesh_from_env
    from repro_torch.models import Model, ModelConfig
    from repro_torch.optim import AdamWConfig, schedules
    from repro_torch.train.trainer import Trainer
    dev, mesh, started = mesh_from_env(device)
    store = None
    if mesh is None:
        store = tempfile.mkdtemp(prefix="quickstart_group_")
        init_process_group(dev, rank=0, world_size=1,
                           init_method=f"file://{store}/store")
        started = True
        mesh = make_host_mesh(device=dev)
    try:
        cfg = ModelConfig(name="quickstart", family="dense", n_layers=2,
                          d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                          d_ff=128, vocab_size=64, param_dtype="float32",
                          compute_dtype="float32")
        model = Model(cfg, device=dev)
        trainer = Trainer(model, mesh,
                          AdamWConfig(lr=schedules.constant(5e-3)))
        params, opt = trainer.init_state()
        data = SyntheticLM(cfg, DataConfig(global_batch=8, seq_len=32))
        params, opt, hist = trainer.run(params, opt, iter(data), 10)
        shape = mesh_shape(mesh)
        print(f"tiny LM on a {shape} mesh ({dist.get_backend()}): loss "
              f"{hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} in "
              f"{len(hist)} steps")
        return {"loss": [h["loss"] for h in hist], "mesh": shape,
                "backend": dist.get_backend()}
    finally:
        if started:
            dist.destroy_process_group()
        if store is not None:
            shutil.rmtree(store, ignore_errors=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; no CPU fallback)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    return {**paper_models(), **executable_emem(device),
            "training": tiny_training(device)}


if __name__ == "__main__":
    main()
