"""Benchmark runner of the port: the modules of ``benchmarks/run.py`` in
its order, each through its port (the paper's figures through
``figs_torch``, then ``emem_bench_torch``, ``vm_bench_torch``,
``kernel_bench_torch`` and ``roofline_torch``).

Prints ``name,us_per_call,derived`` CSV rows.  ``[filter]`` keeps the
modules whose reference name contains it, as ``run.py``'s does; the
benches that time run on the card (``--device cpu`` for the plain
versions on the host).

Run: PYTHONPATH=src:. python -m benchmarks.run_torch [filter] [--device cpu]
"""
from __future__ import annotations

import argparse

from benchmarks.common import print_csv


def modules(device=None) -> list[tuple[str, object]]:
    """(reference module name, rows function) in ``run.py``'s order."""
    from benchmarks import (emem_bench_torch, figs_torch, kernel_bench_torch,
                            roofline_torch, vm_bench_torch)
    figs = [(name, getattr(figs_torch, name)) for name in (
        "fig5_chip_area", "fig6_components", "fig7_interposer",
        "fig9_latency", "fig10_slowdown", "fig11_mix_sweep", "fig12_cache",
        "fig13_tiers", "tab_binary_size")]
    return figs + [
        ("emem_bench", lambda: emem_bench_torch.rows(device)),
        ("vm_bench", lambda: vm_bench_torch.collect(device=device)[0]),
        ("kernel_bench", lambda: kernel_bench_torch.rows(device)),
        ("roofline", roofline_torch.rows)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("only", nargs="?", default=None)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    rows = []
    for name, fn in modules(args.device):
        if args.only and args.only not in name:
            continue
        rows.extend(fn())
    print_csv(rows)


if __name__ == "__main__":
    main()
