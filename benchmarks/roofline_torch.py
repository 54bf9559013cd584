"""Roofline table of the port: reads the port's dry-run artifacts
(``results/dryrun_torch/``, written by ``python -m
repro_torch.launch.dryrun``) and renders one row per (arch x shape x mesh)
cell, as ``benchmarks/roofline.py`` renders the reference's.

Each row: the three roofline terms in seconds on an H100 SXM5 80GB at 700
W (989 TFLOP/s bf16, 3.35 TB/s HBM3, links at 450 GB/s NVLink within an
8-GPU node and 50 GB/s a NIC across nodes), the dominant one,
MODEL_FLOPS over counted FLOPs, the peak bytes a device holds against its
80 GB, the share of the step every tensor-parallel rank computes alike,
and one line on what would move the dominant term.  The terms are one
rank's counted step (the unfused bytes of every op: an upper bound on HBM
traffic); a device time measured on the card is
``chip_smoke.py``'s phase dryrun.

Run: PYTHONPATH=src:. python -m benchmarks.roofline_torch
"""
from __future__ import annotations

import glob
import json
import os

from benchmarks.common import print_csv, row

RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "results", "dryrun_torch")


def load_cells(results: str = RESULTS) -> list[dict]:
    cells = []
    for path in sorted(glob.glob(os.path.join(results, "*.json"))):
        with open(path) as f:
            cells.append(json.load(f))
    return cells


def hint(cell: dict) -> str:
    """One sentence: what moves the dominant term down on the H100."""
    dom = cell["roofline"]["dominant"]
    kind = cell.get("kind")
    first = ""
    if cell.get("replicated_over_tp", 0.0) > 0.5:
        first = ("split the step's heads and MLP columns over the model "
                 "axis (every tp rank computes it whole); then ")
    if dom == "compute":
        if kind == "train":
            return first + ("a remat policy that saves attention outputs, to "
                            "cut the recomputed forward on the tensor cores")
        return first + "a larger per-step batch to amortize; tensor-core bound"
    if dom == "memory":
        if kind == "decode":
            return first + ("KV and weight reads at 3.35 TB/s: fp8 KV "
                            "(K1/K2/K4 refuse it today) or multi-token "
                            "decode")
        return first + ("operand re-reads of the unfused eager ops: fused "
                        "kernels (K3/K5 in place of the plain attention and "
                        "scan) and bf16 intermediates")
    return first + ("collective bytes over the 50 GB/s NIC: bf16 "
                    "collectives, reduce-scatter in place of all-reduce, tp "
                    "within one 8-GPU NVLink node")


def rows(results: str = RESULTS) -> list[dict]:
    out = []
    for c in load_cells(results):
        name = f"roofline/{c['arch']}/{c['shape']}/{c['mesh']}"
        if c["status"] == "skipped":
            out.append(row(name, 0.0, f"SKIP: {c['reason'][:60]}"))
            continue
        if c["status"] != "ok":
            out.append(row(name, 0.0, f"ERROR: {c.get('error', '')[:60]}"))
            continue
        r = c["roofline"]
        terms = (f"comp={r['compute_s']:.3g}s mem={r['memory_s']:.3g}s "
                 f"coll={r['collective_s']:.3g}s dom={r['dominant']}")
        ratio = c.get("useful_flops_ratio")
        if ratio:
            terms += f" useful={ratio:.3g}"
        terms += (f" peak={c['memory']['peak_bytes'] / 1e9:.1f}GB "
                  f"fits_80gb={c['fits_80gb']} "
                  f"tp_replicated={c['replicated_over_tp']:.2f}"
                  f" -> {hint(c)}")
        out.append(row(name, 0.0, terms))
    if not out:
        out.append(row("roofline/none", 0.0, "no dry-run artifacts yet (run "
                       "python -m repro_torch.launch.dryrun)"))
    return out


if __name__ == "__main__":
    print_csv(rows())
