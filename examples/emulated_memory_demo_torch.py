"""The paper's experiment, end to end, on the PyTorch port: a 'sequential
client' performing random accesses against (a) a modelled DDR3 DRAM and
(b) the emulated distributed memory -- the analytic model (the paper's
numbers, ``repro_torch.core``) and the executable EMem (``read_ref`` /
``write_ref`` on the device), as ``examples/emulated_memory_demo.py`` does
over ``repro``.  Runs on ``cuda`` unless ``--device cpu``.

Run: PYTHONPATH=src python examples/emulated_memory_demo_torch.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import dram, emem, emulation, latency  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402


def analytic() -> dict:
    print("== analytic (the paper's evaluation) ==")
    base = dram.paper_baseline(1)
    for n in (16, 256, 1024, 4096):
        clos = latency.mean_access_latency_ns("clos", 4096, n)
        mesh = latency.mean_access_latency_ns("mesh", 4096, n)
        print(f"  {n:5d} tiles: clos {clos:6.1f} ns ({clos / base:4.2f}x "
              f"DDR3)   mesh {mesh:6.1f} ns")
    out = {}
    for mix in (emulation.DHRYSTONE, emulation.COMPILER):
        out[mix.name] = emulation.slowdown(mix, "clos", 4096, 4096)
        print(f"  {mix.name}: slowdown {out[mix.name]:.2f}x  (paper: 2-3x)")
    return out


def executable(device) -> dict:
    print(f"== executable (EMem on {device}) ==")
    spec = emem.EMemSpec(n_slots=1 << 14, width=16, page_slots=64, n_shards=1)
    mem = emem.create(spec, device=device)
    rng = np.random.default_rng(0)

    # a sequential client: chase pointers through the emulated memory
    n_hops = 64
    ptrs = rng.permutation(spec.n_slots).astype(np.int32)
    table = torch.tensor(ptrs[:, None].repeat(spec.width, 1)
                         .astype(np.float32), device=mem.device)
    emem.write_ref(spec, mem, torch.arange(spec.n_slots, device=mem.device),
                   table)

    addr = torch.zeros(1, dtype=torch.int32, device=mem.device)
    path = [0]
    for _ in range(n_hops):
        val = emem.read_ref(spec, mem, addr)           # READ message
        addr = val[:, 0].to(torch.int32) % spec.n_slots
        path.append(int(addr[0]))
    want = [0]
    for _ in range(n_hops):
        want.append(int(ptrs[want[-1]]))
    if path != want:
        raise AssertionError("the pointer chase left the permutation")
    print(f"  pointer chase of {n_hops} hops through "
          f"{spec.bytes_total / 1e6:.1f} MB emulated memory: "
          f"visited {len(set(path))} distinct slots")
    st = emem.dispatch_stats(
        emem.EMemSpec(1 << 22, 128, 256, n_shards=256), 2048, 1.5)
    print(f"  at pod scale (256 shards): {st['a2a_bytes_per_shard'] / 1e6:.1f}"
          f" MB a2a per shard per batch, overflow p={st['p_queue_overflow']:.1e}")
    return {"hops": n_hops, "distinct": len(set(path)), "dispatch": st}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; no CPU fallback)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    return {"slowdown": analytic(), "emem": executable(device)}


if __name__ == "__main__":
    main()
