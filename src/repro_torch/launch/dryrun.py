"""Multi-pod dry-run: one rank's step of every (arch x shape x mesh) cell,
counted on meta tensors (a port of ``repro.launch.dryrun``).

For each cell this tool starts a fake process group of 256 or 512 ranks
(:func:`repro_torch.launch.mesh.start_fake_group`: this process plays rank
0, every collective returns at once), lays the production mesh over it
(16x16 single-pod or 2x16x16 multi-pod, device type ``meta``), installs
the mesh context the cell's rule set reads (``config_for_shape``:
``fsdp_tp`` for training, ``tp_only`` for serving), and runs rank 0's step
through the port's own paths on ``meta`` tensors, shapes without storage:

  * train   -- ``Trainer(model, mesh)``'s step (``make_train_step``, with the
               reference's ``_auto_microbatches``) on the rank's rows;
  * prefill -- ``Model.prefill`` on the rank's rows (enc-dec:
               ``prepare_cross_cache`` over ``init_cache``);
  * decode  -- ``Model.decode_step`` over ``init_cache``: the batch layout
               on the rank's rows, the paged layout (long_500k) through the
               rank body of ``parallel/paged_attention.py`` over this
               rank's block of pages.

Every step runs on the rank's shards of the weights (``Model.shard``,
the tensor-parallel split form: its attention heads, MLP columns,
experts, Mamba2 heads and vocab block over "model"), every arch alike: a
train step through ``Trainer``, which gathers each leaf over the data
axes only and takes the loss and gradients on the split form.

The rank's rows are the global batch split over the data axes, or the
whole batch where it does not split (the reference's replicated batch).
The step runs under :class:`repro_torch.launch.hlo_analysis.CostCounter`.
Its FLOPs, bytes and collectives come from the reference's two-point depth
probes (:func:`_probe_cfg` at 1 and 2 depth units, extrapolated linearly
over :func:`_probe_units`), which keep a 32k prefill or a 500k decode to
seconds.  Peak memory per device is measured at full depth where the
probes' op counts, extrapolated, say that run stays within
:data:`FULL_DEPTH_MAX_OPS` aten ops (a few seconds of host time), else
extrapolated from probes at the cell's own microbatching; the record says
which.  The choice is the shapes', not the host's speed.  Every counted number is one rank's: the port's paths run the same
on every rank of a data-parallel group.

Records keep the reference's keys (``status`` ok / skipped / error with
its traceback, ``roofline``, ``collectives``, ``model_flops_per_device``,
``useful_flops_ratio``) and add ``memory`` (peak bytes per device),
``fits_80gb``, ``roofline_analytic`` (the memory term from
``analytic_hbm_bytes``) and ``replicated_over_tp``: the share of the
depth-1 step's FLOPs that every rank of the "model" axis computes alike,
where the reference splits them, read from the same step counted on a
mesh whose "model" axis has one rank (0: split as the reference splits;
1: every tp rank computes the whole step).

Results land in ``results/dryrun_torch/<arch>__<shape>__<mesh>.json``
(never ``results/dryrun/``, the reference's).  No card is used: this is a
host-only tool.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs import (SHAPES, applicable, config_for_shape,
                                 get_config, input_specs, list_archs)
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch.mesh import (dp_axes, end_fake_group,
                                     make_production_mesh, mesh_shape,
                                     start_fake_group)
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.parallel import mesh_ctx
from repro_torch.train import trainer as trainer_mod

RESULTS_DIR = os.path.normpath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "results", "dryrun_torch"))
#: aten ops a cell's full-depth run may take (~3 s of host time at the
#: 5-8k ops/s counted on meta); past it the peak memory is extrapolated
#: from the probes
FULL_DEPTH_MAX_OPS = 20_000


def _auto_microbatches(cfg, batch: int, seq: int, dp: int) -> int:
    """Activation-residual heuristic: keep per-device scan residuals under
    ~6 GB (bf16 carries saved per scan step by the remat'd backward)."""
    b_loc = max(1, batch // dp)
    resid = cfg.n_layers * b_loc * seq * cfg.d_model * 2
    m = 1
    while resid / m > 6e9 and m < b_loc:
        m *= 2
    return m


def _probe_cfg(cfg, k: int):
    """Depth-k variant for the two-point cost probes (the reference's).

    The reference needs them because XLA's cost analysis counts a loop body
    once; the port's eager step counts every layer, and the probes keep a
    long cell's run to seconds.  Per-cell totals are the linear
    extrapolation in depth, exact for depth-linear costs (layers are
    homogeneous per period), with the depth-independent base (embedding,
    head, optimizer) in the intercept.  ``unroll_layers`` makes the
    attention skip fully masked chunk pairs (K3's work); the port reads no
    other part of it, nor ``ssd_probe_unroll``."""
    updates = dict(unroll_layers=True, attn_chunk_q=2048, attn_chunk_k=2048)
    if cfg.family == "hybrid":
        updates["ssd_probe_unroll"] = False
    if cfg.family == "encdec":
        updates.update(n_layers=k, n_encoder_layers=k)
    else:
        updates.update(n_layers=cfg.layer_period * k)
    return dataclasses.replace(cfg, **updates)


def _probe_units(cfg) -> int:
    """Number of depth units the probes extrapolate over."""
    return cfg.n_layers if cfg.family == "encdec" else cfg.n_periods


def _rows(batch: int, dp: int) -> int:
    """A rank's rows of a global batch: its data-parallel block, or the
    whole batch where the batch does not split."""
    return batch // dp if batch % dp == 0 else batch


def _meta(like: torch.Tensor, rows: int) -> torch.Tensor:
    return torch.empty((rows,) + tuple(like.shape[1:]), dtype=like.dtype,
                       device="meta")


def _dp_size(mesh, dp: tuple) -> int:
    return math.prod(mesh_shape(mesh)[a] for a in dp)


def build_step(cfg, shape: ShapeSpec, specs: dict, mesh, dp: tuple,
               microbatches: int | None = None):
    """One rank's step of ``cfg`` at ``shape`` on ``mesh``, on meta
    tensors: ``(run, resident, extra)`` -- ``run()`` takes the step,
    ``resident`` holds what the rank keeps across steps (weights, state,
    cache, batch), ``extra`` the record's fields.  Every step runs on the
    rank's shards of the weights (``Model.shard``: its heads, MLP columns,
    experts, SSM heads, vocab block over "model"; a train step through
    ``Trainer``, which splits its model at tp > 1); on a mesh whose
    "model" axis has one rank nothing splits.
    Installs the mesh context; the caller clears it."""
    model = Model(cfg, device="meta")
    n_dp = _dp_size(mesh, dp)
    # where the batch splits, the rank runs its rows of the reference's
    # global batch (dp_rows): an MoE block fills capacity over every rank's
    # rows, as GSPMD does
    mesh_ctx.set_context(mesh, batch_axes=dp, tp_axis="model", kv_axes=dp,
                         dp_rows=shape.global_batch % n_dp == 0)
    rows = _rows(shape.global_batch, n_dp)
    batch = {k: _meta(v, rows) for k, v in specs.items()}
    extra = {"params": model.param_count(), "rows_per_rank": rows}
    if shape.kind == "train":
        m = microbatches or _auto_microbatches(
            cfg, shape.global_batch, shape.seq_len, n_dp)
        tcfg = trainer_mod.TrainConfig(microbatches=m, dp_axes=dp)
        trainer = trainer_mod.Trainer(model, mesh, adamw.AdamWConfig(), tcfg)
        params, opt = trainer.init_state()
        extra["microbatches"] = m
        extra["split_form"] = trainer.model.tp_shard is not None
        return (lambda: trainer.step_fn(params, opt, batch),
                (trainer.model.param_tree(), params, opt, batch), extra)
    if mesh_shape(mesh)["model"] > 1:
        model = model.shard()
    extra["split_form"] = model.tp_shard is not None
    seq = shape.seq_len
    src = {"src_len": seq} if cfg.family == "encdec" else {}
    if shape.kind == "prefill":
        if cfg.family == "encdec":
            cache = model.init_cache(rows, seq, **src)
            return (lambda: model.prepare_cross_cache(batch["embeds"], cache),
                    (model.param_tree(), cache, batch), extra)
        return (lambda: model.prefill(batch, max_len=seq),
                (model.param_tree(), batch), extra)
    cache = model.init_cache(rows, seq, **src)
    return (lambda: model.decode_step(batch["tokens"], cache,
                                      batch["lengths"]),
            (model.param_tree(), cache, batch), extra)


def count_step(cfg, shape: ShapeSpec, specs: dict, mesh, dp: tuple,
               microbatches: int | None = None) -> dict:
    """One rank's counted step: flops, bytes, collectives, peak bytes,
    seconds of host time."""
    from torch.fx.experimental import _config as fx_config
    try:
        run, resident, extra = build_step(cfg, shape, specs, mesh, dp,
                                          microbatches)
        t0 = time.monotonic()
        with fx_config.patch(meta_nonzero_assume_all_nonzero=True), \
                H.CostCounter(resident=resident) as c:
            run()
        seconds = time.monotonic() - t0
    finally:
        mesh_ctx.clear_context()
    return {"flops": float(c.flops), "hbm_bytes": float(c.bytes_accessed),
            "coll_bytes": float(c.collectives.total_bytes),
            "coll_by_op": dict(c.collectives.bytes_by_op),
            "coll_count_by_op": dict(c.collectives.count_by_op),
            "peak_bytes": float(c.peak_bytes),
            "resident_bytes": float(c.resident_bytes),
            "ops": c.ops, "seconds": seconds, **extra}


def _lin(p1, p2, n: int):
    """The probes' value extrapolated to ``n`` depth units."""
    if isinstance(p1, dict):
        return {k: _lin(p1[k], p2.get(k, 0), n) for k in p1}
    return p1 + (p2 - p1) * (n - 1)


def _tp1_mesh(mesh, dp: tuple):
    """The mesh's data axes over its first ranks with a "model" axis of
    one rank: the step as the port would run it unsplit."""
    from torch.distributed.device_mesh import DeviceMesh
    sizes = mesh_shape(mesh)
    shape = tuple(sizes[a] for a in dp) + (1,)
    return DeviceMesh(mesh.device_type,
                      torch.arange(math.prod(shape)).reshape(shape),
                      mesh_dim_names=dp + ("model",))


def measure(cfg, shape: ShapeSpec, specs_for, mesh, dp: tuple) -> dict:
    """The record's counted fields for ``cfg`` at ``shape`` on ``mesh``:
    probes at 1 and 2 depth units (train steps at one microbatch, as the
    reference's), extrapolated; peak memory at full depth or extrapolated
    from probes at the cell's microbatching; ``replicated_over_tp`` from the
    depth-1 probe on the mesh's tp-1 twin (the step on whole weights; its
    flops and peak bytes are kept as ``tp1_twin``).  ``specs_for(cfg)``
    gives a config's input specs."""
    train = shape.kind == "train"
    n_units = _probe_units(cfg)
    probes = {}
    for k in (1, 2):
        pcfg = _probe_cfg(cfg, k)
        probes[k] = count_step(pcfg, shape, specs_for(pcfg), mesh, dp,
                               microbatches=1 if train else None)
    m = (_auto_microbatches(cfg, shape.global_batch, shape.seq_len,
                            _dp_size(mesh, dp)) if train else 1)
    mem_probes = probes
    if m > 1:
        mem_probes = {k: count_step(_probe_cfg(cfg, k), shape,
                                    specs_for(_probe_cfg(cfg, k)), mesh, dp,
                                    microbatches=m)
                      for k in (1, 2)}
    est_ops = _lin(mem_probes[1]["ops"], mem_probes[2]["ops"], n_units)
    if est_ops <= FULL_DEPTH_MAX_OPS:
        full = count_step(cfg, shape, specs_for(cfg), mesh, dp,
                          microbatches=m if train else None)
        memory = {"peak_bytes": full["peak_bytes"],
                  "resident_bytes": full["resident_bytes"],
                  "how": "full_depth", "full_depth_s": full["seconds"]}
    else:
        memory = {"peak_bytes": _lin(mem_probes[1]["peak_bytes"],
                                     mem_probes[2]["peak_bytes"], n_units),
                  "resident_bytes": _lin(mem_probes[1]["resident_bytes"],
                                         mem_probes[2]["resident_bytes"],
                                         n_units),
                  "how": "extrapolated", "full_depth_est_ops": est_ops}
    tp = mesh_shape(mesh)["model"]
    replicated, twin_rec = 0.0, None
    if tp > 1:
        pcfg = _probe_cfg(cfg, 1)
        twin = count_step(pcfg, shape, specs_for(pcfg), _tp1_mesh(mesh, dp),
                          dp, microbatches=1 if train else None)
        r = probes[1]["flops"] / twin["flops"] if twin["flops"] else 1.0
        replicated = (r - 1.0 / tp) / (1.0 - 1.0 / tp)
        twin_rec = {k: twin[k] for k in ("flops", "peak_bytes")}
    n_dev = math.prod(mesh_shape(mesh).values())
    roof = H.Roofline(flops=_lin(probes[1]["flops"], probes[2]["flops"],
                                 n_units),
                      hbm_bytes=_lin(probes[1]["hbm_bytes"],
                                     probes[2]["hbm_bytes"], n_units),
                      coll_bytes_per_device=max(0.0, _lin(
                          probes[1]["coll_bytes"], probes[2]["coll_bytes"],
                          n_units)),
                      n_devices=n_dev)
    n_dp = _dp_size(mesh, dp)
    analytic = H.Roofline(
        flops=roof.flops,
        hbm_bytes=H.analytic_hbm_bytes(cfg, shape, n_dev=n_dev, dp=n_dp,
                                       tp=tp, microbatches=m),
        coll_bytes_per_device=roof.coll_bytes_per_device, n_devices=n_dev)
    tokens = shape.global_batch * (shape.seq_len
                                   if shape.kind != "decode" else 1)
    mf = H.model_flops(cfg.param_count(active_only=True), tokens,
                       train=train) / n_dev
    return {
        "kind": shape.kind, "n_devices": n_dev, "microbatches": m,
        "params": probes[1]["params"],
        "rows_per_rank": probes[1]["rows_per_rank"],
        "split_form": probes[1]["split_form"],
        "probes": {k: {key: p[key] for key in (
            "flops", "hbm_bytes", "coll_bytes", "coll_by_op",
            "coll_count_by_op", "peak_bytes", "ops", "seconds")}
            for k, p in probes.items()},
        "collectives": {
            "bytes_by_op": _lin(probes[1]["coll_by_op"],
                                probes[2]["coll_by_op"], n_units),
            "count_by_op": _lin(probes[1]["coll_count_by_op"],
                                probes[2]["coll_count_by_op"], n_units),
            "total_bytes": roof.coll_bytes_per_device},
        "roofline": roof.as_dict(),
        "roofline_analytic": analytic.as_dict(),
        "memory": memory,
        "fits_80gb": memory["peak_bytes"] <= H.DEVICE_BYTES,
        "replicated_over_tp": replicated,
        "tp1_twin": twin_rec,
        "model_flops_per_device": mf,
        "useful_flops_ratio": mf / roof.flops if roof.flops else None,
    }


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             out_dir: str = RESULTS_DIR, overrides: dict | None = None,
             tag: str = "") -> dict:
    """Count one cell; returns (and writes) the result record.

    ``overrides``: ModelConfig field overrides; ``tag`` suffixes the
    artifact filename so variants sit beside baselines.  Starts the fake
    group of the cell's mesh and ends it before returning, so a default
    group must not be running."""
    multi_pod = mesh_kind == "multi"
    record: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                    "status": "ok", "tag": tag,
                    "overrides": overrides or {}}
    base = get_config(arch)
    ok, why = applicable(base, shape_name)
    if not ok:
        record.update(status="skipped", reason=why, seconds=0.0)
        _write(record, out_dir)
        return record
    cfg = config_for_shape(base, shape_name)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    t0 = time.monotonic()
    start_fake_group(512 if multi_pod else 256)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        record.update(measure(cfg, shape,
                              lambda c: input_specs(c, shape_name), mesh,
                              dp_axes(multi_pod)))
    except Exception as e:  # record failures: they are bugs to fix
        record.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-4000:])
    finally:
        end_fake_group()
    record["seconds"] = time.monotonic() - t0
    _write(record, out_dir)
    return record


#: the shapes whose input specs a step of each kind takes
_KIND_SHAPES = {"train": "train_4k", "prefill": "prefill_32k",
                "decode": "decode_32k"}


def count_on_one_rank(cfg, kind: str, batch: int, seq: int) -> dict:
    """:func:`measure`'s fields for ``cfg``'s step of ``kind`` at ``batch``
    rows of ``seq`` tokens (decode: a cache of ``seq`` positions) on a
    (1, 1) mesh of a fake group of one rank: the count of the step one
    card runs, whose device time a measurement can stand beside."""
    from repro_torch.launch.mesh import make_mesh
    shape = ShapeSpec(f"{kind}_{batch}x{seq}", seq, batch, kind)
    start_fake_group(1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="meta")
        return measure(cfg, shape, lambda c: input_specs(
            c, _KIND_SHAPES[kind], reduced=(batch, seq)), mesh, ("data",))
    finally:
        end_fake_group()


def _write(record: dict, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    tag = record.get("tag") or ""
    suffix = f"__{tag}" if tag else ""
    name = (f"{record['arch']}__{record['shape']}__{record['mesh']}"
            f"{suffix}.json")
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(record, f, indent=1, default=float)


def summary(rec: dict) -> str:
    """One line of a record: status, dominant term, per-device GB,
    ``fits_80gb``, ``useful_flops_ratio``, the tp-replicated share."""
    head = f"[{rec['status']}] {rec['arch']} {rec['shape']} {rec['mesh']}"
    if rec["status"] == "skipped":
        return f"{head} {rec['reason'][:60]}"
    if rec["status"] == "error":
        return f"{head} {rec['error'][:160]}"
    r = rec["roofline"]
    return (f"{head} dom={r['dominant']} comp={r['compute_s']:.3g}s "
            f"mem={r['memory_s']:.3g}s coll={r['collective_s']:.3g}s "
            f"peak={rec['memory']['peak_bytes'] / 1e9:.1f}GB "
            f"({rec['memory']['how']}) fits_80gb={rec['fits_80gb']} "
            f"useful={rec['useful_flops_ratio']:.3g} "
            f"tp_replicated={rec['replicated_over_tp']:.2f}")


def _parse_overrides(items: list[str]) -> dict:
    from repro_torch.models.config import ModelConfig
    fields = {f.name: f for f in dataclasses.fields(ModelConfig)}
    overrides = {}
    for ov in items:
        key, val = ov.split("=", 1)
        ftype = str(fields[key].type)
        if "int" in ftype:
            overrides[key] = int(val)
        elif "float" in ftype and "float8" not in val:
            overrides[key] = float(val)
        elif "bool" in ftype:
            overrides[key] = val.lower() in ("1", "true", "yes")
        else:
            overrides[key] = None if val == "none" else val
    return overrides


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs())
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--override", action="append", default=[],
                    help="ModelConfig field override, e.g. remat=dots")
    ap.add_argument("--tag", default="", help="artifact filename suffix")
    args = ap.parse_args(argv)
    overrides = _parse_overrides(args.override)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(arch, shape, m) for arch in list_archs() for shape in SHAPES
                 for m in meshes]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape, m) for m in meshes]

    for arch, shape, m in cells:
        path = os.path.join(args.out, f"{arch}__{shape}__{m}.json")
        if args.skip_existing and os.path.exists(path):
            with open(path) as f:
                if json.load(f).get("status") in ("ok", "skipped"):
                    print(f"[skip] {arch} {shape} {m}")
                    continue
        t0 = time.monotonic()
        rec = run_cell(arch, shape, m, args.out, overrides=overrides,
                       tag=args.tag)
        print(f"{summary(rec)} ({time.monotonic() - t0:.1f}s)", flush=True)


if __name__ == "__main__":
    main()
