"""EMem microbenchmark on the port: random read/write throughput on the
card plus the analytic dispatch cost at production scale (the rows of
``benchmarks/emem_bench.py``, the executable counterpart of the paper's
Fig. 9).

The reads and writes go through ``repro_torch.core.emem.read``/``write``
at one shard (the slot gather K7 and the last-writer scatter on the card),
timed with CUDA events (``kernel_bench_torch.device_us``: queued behind a
sleep kernel, or at the host's pace where a call syncs); the dispatch
rows are
``emem.dispatch_stats``' arithmetic for 16 and 256 shards.

Run: PYTHONPATH=src:. python -m benchmarks.emem_bench_torch
(``--device cpu`` runs the plain versions on the host instead).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from benchmarks.common import print_csv, row
from benchmarks.kernel_bench_torch import device_us
from repro_torch.core import emem
from repro_torch.device import resolve_device


def rows(device=None) -> list[dict]:
    dev = resolve_device(device)
    out = []
    rng = np.random.default_rng(0)
    for n_slots, width in ((1 << 14, 64), (1 << 16, 128)):
        spec = emem.EMemSpec(n_slots=n_slots, width=width, page_slots=128,
                             n_shards=1)
        data = emem.create(spec, dev)
        addrs = torch.tensor(rng.integers(0, n_slots, 4096).astype(np.int32),
                             device=dev)
        vals = torch.tensor(rng.normal(size=(4096, width)).astype(np.float32),
                            device=dev)
        us_r, clock_r = device_us(lambda: emem.read(spec, data, addrs), dev)
        us_w, clock_w = device_us(lambda: emem.write(spec, data, addrs, vals),
                                  dev)
        gb = 4096 * width * 4 / 1e9
        out.append(row(f"emem/read/{n_slots}x{width}", us_r,
                       f"{gb / (us_r / 1e6):.2f} GB/s effective ({clock_r})"))
        out.append(row(f"emem/write/{n_slots}x{width}", us_w,
                       f"{gb / (us_w / 1e6):.2f} GB/s effective ({clock_w})"))
    # analytic dispatch traffic at production scale (256-chip pod)
    for shards in (16, 256):
        spec = emem.EMemSpec(n_slots=1 << 24, width=128, page_slots=256,
                             n_shards=shards)
        st = emem.dispatch_stats(spec, n_requests_per_shard=4096,
                                 capacity_factor=1.5)
        out.append(row(
            f"emem/dispatch/{shards}shards", 0.0,
            f"a2a={st['a2a_bytes_per_shard'] / 1e6:.2f}MB/shard "
            f"p_overflow={st['p_queue_overflow']:.2e} cap={st['capacity']}"))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain versions")
    print_csv(rows(ap.parse_args(argv).device))


if __name__ == "__main__":
    main()
