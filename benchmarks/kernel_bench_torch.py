"""Kernel micro-benchmarks on the port: K3, K4, K5 and K6 at the shapes of
``benchmarks/kernel_bench.py``'s rows, with H100 bounds.

Each row times the kernel through its public op (``flash_attention``,
``decode_attention``, ``ssd``, ``gather_pages``) in bf16 (K6: the f32
store of the reference's row) on the card with CUDA events
(:func:`device_us`: the calls queued behind a sleep kernel, so the time
is the card's and not the Python wrapper's), and derives
the work's FLOPs or bytes and the least time an H100 SXM5 80GB at 700 W
could take for it (989 TFLOP/s bf16, 3.35 TB/s; the larger of the two
terms, each input read once and each output written once).  The
reference's sixth row, the table-walking paged-decode step against the
composed one, is ``benchmarks/vm_bench_torch.py``'s ``paged_decode``
section on the port, which runs K1 and K2 and checks them; this module
points there instead of repeating it.

Run: PYTHONPATH=src:. python -m benchmarks.kernel_bench_torch
(``--device cpu`` times the plain versions on the host instead).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from benchmarks.common import print_csv, row, timeit
from repro_torch.device import resolve_device
from repro_torch.launch.hlo_analysis import HBM_BW, PEAK_FLOPS_BF16


def device_us(fn, dev: torch.device, iters: int = 20, warmup: int = 3,
              sleep_cycles: int = 50_000_000) -> tuple[float, str]:
    """(microseconds per call of ``fn()``, the clock): on a CUDA device
    CUDA events around ``iters`` calls queued behind a ~25 ms sleep
    kernel, so the card runs them back to back whatever the Python
    wrapper's time ("queued"), or, where the card reached the first event
    before the host had queued every call (``fn`` syncs with the host),
    the events around the same loop at the host's pace ("loop");
    elsewhere the host's median wall time ("host")."""
    if dev.type != "cuda":
        return timeit(fn, warmup=warmup, iters=iters), "host"
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    late = start.query()
    torch.cuda.synchronize(dev)
    if not late:
        return start.elapsed_time(end) * 1e3 / iters, "queued"
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) * 1e3 / iters, "loop"


def bound_us(flops: float, nbytes: float) -> tuple[float, str]:
    """(least H100 time in us, "operations" or "bytes")."""
    compute, memory = flops / PEAK_FLOPS_BF16, nbytes / HBM_BW
    return max(compute, memory) * 1e6, ("operations" if compute > memory
                                        else "bytes")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def rows(device=None) -> list[dict]:
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mamba2_ssd import ops as ssd_ops
    from repro_torch.kernels.paged_decode import flash_ops, gather_ops
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    bf16 = torch.bfloat16

    def t(*shape, dtype=bf16, dist=None):
        a = rng.normal(size=shape) if dist is None else dist(shape)
        return torch.tensor(a.astype(np.float32), device=dev).to(dtype)

    out = []
    # K3 flash attention (kernel_bench.py:110-120)
    B, Hq, Hkv, S, D = 1, 8, 2, 1024, 64
    q, k, v = t(B, Hq, S, D), t(B, Hkv, S, D), t(B, Hkv, S, D)
    us, clock = device_us(
        lambda: fa_ops.flash_attention(q, k, v, causal=True), dev)
    flops = 2 * 2 * B * Hq * S * S * D * 0.5
    b_us, by = bound_us(flops, _nbytes(q, k, v, q))
    out.append(row("kernel/flash_attn/1x8x1024x64", us,
                   f"{flops / 1e9:.2f} GFLOP -> bound {b_us:.2f}us on H100 "
                   f"({by}); {clock}"))

    # K4 decode attention over a batch-layout cache (kernel_bench.py:122-132)
    kc, vc, qd = t(4, Hkv, 4096, D), t(4, Hkv, 4096, D), t(4, Hq, D)
    lengths = torch.full((4,), 4096, dtype=torch.int32, device=dev)
    us, clock = device_us(
        lambda: flash_ops.decode_attention(qd, kc, vc, lengths), dev)
    kv_bytes = _nbytes(kc, vc)
    b_us, by = bound_us(4 * 4 * Hq * 4096 * D, kv_bytes + 2 * _nbytes(qd))
    out.append(row("kernel/decode_attn/4x8x4096", us,
                   f"kv={kv_bytes / 1e6:.1f}MB -> bound {b_us:.2f}us on "
                   f"H100 ({by}); {clock}"))

    # K5 Mamba2 SSD (kernel_bench.py:134-149)
    Bt, Sm, H, P, N, Q = 1, 2048, 8, 64, 64, 128
    x = t(Bt, Sm, H, P)
    dt = t(Bt, Sm, H, dtype=torch.float32,
           dist=lambda s: rng.uniform(0.01, 0.2, s))
    A = t(H, dtype=torch.float32, dist=lambda s: -rng.uniform(0.5, 2, s))
    Bm, Cm = t(Bt, Sm, 1, N), t(Bt, Sm, 1, N)
    Dm = t(H, dtype=torch.float32)
    us, clock = device_us(
        lambda: ssd_ops.ssd(x, dt, A, Bm, Cm, Dm, chunk=Q), dev)
    ssd_flops = Bt * H * (Sm // Q) * (2 * Q * Q * N + 2 * Q * Q * P
                                      + 4 * Q * N * P)
    b_us, by = bound_us(ssd_flops, _nbytes(x, dt, A, Bm, Cm, Dm, x)
                        + Bt * H * N * P * 4)
    out.append(row("kernel/mamba2_ssd/2048x8x64", us,
                   f"{ssd_flops / 1e9:.2f} GFLOP chunked -> bound "
                   f"{b_us:.2f}us on H100 ({by}); {clock}"))

    # K6 whole-page gather, EMemVM's fills (kernel_bench.py:151-161)
    pages = t(256, 128, 128, dtype=torch.float32)
    ids = torch.tensor(rng.integers(0, 256, 64).astype(np.int32), device=dev)
    us, clock = device_us(lambda: gather_ops.gather_pages(pages, ids), dev)
    gbytes = 64 * 128 * 128 * 4
    b_us, by = bound_us(0.0, 2 * gbytes + _nbytes(ids))
    out.append(row("kernel/emem_gather/64pages", us,
                   f"{gbytes / 1e6:.1f}MB -> bound {b_us:.2f}us on H100 "
                   f"({by}); {clock}"))

    out.append(row("kernel/paged_decode/sweep", 0.0,
                   "K1+K2 table walk vs composed: benchmarks/"
                   "vm_bench_torch.py section paged_decode"))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain versions")
    print_csv(rows(ap.parse_args(argv).device))


if __name__ == "__main__":
    main()
