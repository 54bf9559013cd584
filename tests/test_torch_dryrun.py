"""The port's dry-run and roofline tooling against the JAX reference on the
CPU: the shapes and their specs, the analytic cost models, the attention
that skips masked chunk pairs, the H100 roofline, the cost counter's
collectives on a fake group and its counts on meta against the CPU, the
production meshes and ``cache_spec``, a cell run end to end, and the
roofline rows over its artifacts.

Tolerances: ``model_flops`` and ``analytic_hbm_bytes`` within rel 1e-12
of the reference's; ``chunked_attention_unrolled`` within atol 1e-5 of the
reference's in f32 (the same arithmetic summed in another order); the
counts exact.  The reference's ``launch/dryrun.py`` sets ``XLA_FLAGS`` at
import, so no test here imports it: its ``_auto_microbatches``,
``_probe_cfg`` and ``_probe_units`` are held to literals taken from its
code."""
import dataclasses
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as jcfgs  # noqa: E402
from repro.launch import hlo_analysis as JH  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import hlo_analysis as H  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

torch.set_num_threads(2)

ARCHS = tcfgs.list_archs()
#: the fields config_for_shape sets
SHAPE_FIELDS = ("logical_rules", "remat", "kv_layout", "kv_page_slots")


@pytest.fixture
def fake_group(request):
    """Start a fake group of ``n`` ranks; it is ended in a finalizer."""
    def start(n):
        M.start_fake_group(n)
        request.addfinalizer(M.end_fake_group)
    return start


def _spec(x):
    return tuple(x.shape), str(x.dtype).replace("torch.", "")


def test_shapes_specs_and_configs_match_reference():
    """SHAPES, applicable, the fields config_for_shape sets and the
    input_specs' shapes and dtypes (meta tensors here, ShapeDtypeStructs
    there) for all ten archs and four shapes, also at reduced=(2, 16)."""
    assert tcfgs.SHAPES.keys() == jcfgs.SHAPES.keys()
    for name, s in tcfgs.SHAPES.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(jcfgs.SHAPES[name])
    assert ARCHS == jcfgs.list_archs()
    for arch in ARCHS:
        tc, jc = tcfgs.get_config(arch), jcfgs.get_config(arch)
        for shape in tcfgs.SHAPES:
            assert tcfgs.applicable(tc, shape) == jcfgs.applicable(jc, shape)
            tcs = tcfgs.config_for_shape(tc, shape)
            jcs = jcfgs.config_for_shape(jc, shape)
            for f in SHAPE_FIELDS:
                assert getattr(tcs, f) == getattr(jcs, f), (arch, shape, f)
            for reduced in (None, (2, 16)):
                got = tcfgs.input_specs(tcs, shape, reduced)
                want = jcfgs.input_specs(jcs, shape, reduced)
                assert got.keys() == want.keys(), (arch, shape)
                for k, v in got.items():
                    assert v.device.type == "meta"
                    assert _spec(v) == (tuple(want[k].shape),
                                        str(want[k].dtype)), (arch, shape, k)


def test_model_flops_and_analytic_hbm_bytes_match_reference():
    """Every arch and shape at (256 devices, dp 16, tp 16, 2 microbatches)
    and (512, dp 32, tp 16), rel 1e-12."""
    for arch in ARCHS:
        for shape in tcfgs.SHAPES:
            tc = tcfgs.config_for_shape(tcfgs.get_config(arch), shape)
            jc = jcfgs.config_for_shape(jcfgs.get_config(arch), shape)
            for n, dp, tp, m in ((256, 16, 16, 2), (512, 32, 16, 1)):
                got = H.analytic_hbm_bytes(tc, tcfgs.SHAPES[shape], n_dev=n,
                                           dp=dp, tp=tp, microbatches=m)
                want = JH.analytic_hbm_bytes(jc, jcfgs.SHAPES[shape],
                                             n_dev=n, dp=dp, tp=tp,
                                             microbatches=m)
                assert got == pytest.approx(want, rel=1e-12), (arch, shape)
            for train in (True, False):
                p = tc.param_count(active_only=True)
                assert H.model_flops(p, 4096, train) == pytest.approx(
                    JH.model_flops(jc.param_count(active_only=True), 4096,
                                   train), rel=1e-12)


def test_chunked_attention_unrolled_matches_reference():
    """Causal, windowed and Sq < Skv (queries at the tail), chunks of 8,
    f32 from seeded numpy inputs: within atol 1e-5 of the reference's, and
    equal to the port's scan form (the skipped pairs add nothing)."""
    rng = np.random.default_rng(3)
    for sq, skv, window in ((16, 16, None), (24, 24, 6), (8, 24, None)):
        q = rng.normal(size=(2, 4, sq, 16)).astype(np.float32)
        k = rng.normal(size=(2, 2, skv, 16)).astype(np.float32)
        v = rng.normal(size=(2, 2, skv, 16)).astype(np.float32)
        kw = dict(causal=True, window=window, chunk_q=8, chunk_k=8)
        got = L.chunked_attention_unrolled(*map(torch.tensor, (q, k, v)),
                                           **kw)
        want = jax.jit(functools.partial(JL.chunked_attention_unrolled,
                                         **kw))(q, k, v)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        scan = L.chunked_attention(*map(torch.tensor, (q, k, v)), **kw)
        np.testing.assert_array_equal(got.numpy(), scan.numpy())


def test_roofline_terms_under_h100_constants():
    """The terms over the H100's rates: 989 TFLOP/s, 3.35 TB/s, NVLink
    450 GB/s within an 8-GPU node and a 50 GB/s NIC beyond one."""
    r = H.Roofline(flops=989e12, hbm_bytes=3.35e12 / 2,
                   coll_bytes_per_device=0.0, n_devices=256)
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(0.5)
    assert r.dominant == "compute" and r.bound_s == pytest.approx(1.0)
    r2 = H.Roofline(flops=0, hbm_bytes=0, coll_bytes_per_device=100e9,
                    n_devices=256)
    assert r2.collective_s == pytest.approx(2.0)
    assert r2.dominant == "collective"
    r8 = H.Roofline(flops=0, hbm_bytes=1.0, coll_bytes_per_device=900e9,
                    n_devices=8)
    assert r8.collective_s == pytest.approx(2.0)
    assert set(r8.as_dict()) == set(JH.Roofline(0, 0, 0, 1).as_dict())


def test_collective_counter_on_a_fake_group(fake_group):
    """On a 4-rank fake group, each collective the port can issue is
    counted once under the reference's key at its result's bytes: the
    ``c10d`` ops of ``torch.distributed`` and ``mesh_ctx`` and the
    ``_c10d_functional`` ops of DTensor's ``full_tensor`` and
    ``redistribute``."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Partial, Shard
    from repro_torch.parallel import mesh_ctx
    fake_group(4)
    group = dist.group.WORLD
    x = torch.ones(8, 4)                                 # 128 bytes
    mesh = M.make_mesh((2, 2), ("data", "model"), device="meta")
    d = DTensor.from_local(torch.empty(4, 2, device="meta"), mesh,
                           (Shard(0), Shard(1)), run_check=False)
    g = DTensor.from_local(torch.empty(8, 4, device="meta"), mesh,
                           (Partial("sum"), Partial("sum")), run_check=False)
    with H.CostCounter() as c:
        dist.all_reduce(x)                               # 128
        mesh_ctx.all_reduce(x, "max", group)             # 128
        dist.all_gather([torch.empty(8, 4) for _ in range(4)], x)   # 512
        mesh_ctx.all_gather(x, group)                    # 512
        mesh_ctx.all_to_all(x, group)                    # 128
        funcol.all_reduce(x, "sum", group).wait()        # 128
        d.full_tensor()                                  # 8x2 + 8x4 f32: 192
        g.redistribute(mesh, (Shard(0), Shard(1)))       # 4x4 + 4x2: 96
    stats = c.collectives
    assert stats.count_by_op == {"all-gather": 4, "all-reduce": 3,
                                 "reduce-scatter": 2, "all-to-all": 1,
                                 "collective-permute": 0,
                                 "ragged-all-to-all": 0}
    assert stats.bytes_by_op == {"all-gather": 2 * 512 + 192,
                                 "all-reduce": 3 * 128,
                                 "reduce-scatter": 96,
                                 "all-to-all": 128,
                                 "collective-permute": 0,
                                 "ragged-all-to-all": 0}


def _smoke_steps(dev):
    """Prefill, decode and a one-device train step of qwen3-0.6b's smoke
    config on ``dev``: each step's (flops, bytes, peak, ops) and the
    weights' shapes."""
    from repro_torch.optim import adamw
    from repro_torch.train import trainer as TR
    cfg = dataclasses.replace(tcfgs.get_smoke_config("qwen3-0.6b"),
                              kv_layout="batch", remat="block")
    model = Model(cfg, device=dev)
    shapes = {k: (tuple(v.shape), v.dtype)
              for k, v in model.state_dict().items()}
    toks = torch.zeros(2, 16, dtype=torch.int32, device=dev)
    out = {}
    with H.CostCounter(resident=model.param_tree()) as c:
        _, cache = model.prefill({"tokens": toks}, 32)
    out["prefill"] = c
    lengths = torch.full((2,), 17, dtype=torch.int32, device=dev)
    with H.CostCounter(resident=(model.param_tree(), cache)) as c:
        model.decode_step(toks[:, :1], cache, lengths)
    out["decode"] = c
    trainer = TR.Trainer(model, None, adamw.AdamWConfig(),
                         TR.TrainConfig(microbatches=2))
    params, opt = trainer.init_state()
    batch = {"tokens": toks, "labels": toks,
             "mask": torch.ones(2, 16, device=dev)}
    with H.CostCounter(resident=(params, opt, batch)) as c:
        trainer.step_fn(params, opt, batch)
    out["train"] = c
    return {k: (c.flops, c.bytes_accessed, c.peak_bytes, c.ops)
            for k, c in out.items()}, shapes


def test_cost_counter_on_meta_equals_the_cpu():
    """A smoke config's prefill, decode and train step count the same
    FLOPs, bytes, peak bytes and ops on meta tensors as on the CPU, and the
    meta build shapes every weight as the drawn build does."""
    cpu, cpu_shapes = _smoke_steps("cpu")
    meta, meta_shapes = _smoke_steps("meta")
    assert meta == cpu
    assert meta_shapes == cpu_shapes
    assert all(v[0] > 0 and v[1] > 0 and v[2] > 0 for v in cpu.values())


def test_production_meshes_and_cache_spec(fake_group):
    """make_production_mesh's (16, 16) and (2, 16, 16) meshes over fake
    groups of 256 and 512 ranks, ended without a trace and refused over a
    running group; cache_spec against the reference's for the batch and
    paged layouts."""
    import torch.distributed as dist
    for multi, n, shape, axes in (
            (False, 256, (16, 16), ("data", "model")),
            (True, 512, (2, 16, 16), ("pod", "data", "model"))):
        M.start_fake_group(n)
        try:
            mesh = M.make_production_mesh(multi_pod=multi)
            assert tuple(mesh.mesh.shape) == shape
            assert tuple(mesh.mesh_dim_names) == axes
            assert mesh.device_type == "meta"
            with pytest.raises(RuntimeError, match="already running"):
                M.start_fake_group(n)
        finally:
            M.end_fake_group()
        assert not dist.is_initialized()
    for arch, layout in (("qwen3-0.6b", "batch"), ("jamba-v0.1-52b", "paged"),
                         ("mamba2-780m", "batch")):
        kw = dict(kv_layout=layout, kv_page_slots=8)
        tc = dataclasses.replace(tcfgs.get_smoke_config(arch), **kw)
        jc = dataclasses.replace(jcfgs.get_smoke_config(arch), **kw)
        got = T.cache_spec(tc, 2, 32)
        want = JT.cache_spec(jc, 2, 32)
        flat = {f"{k}/{n}": v for k, e in got.items() for n, v in e.items()}
        wflat = {f"{k}/{n}": v for k, e in want.items() for n, v in e.items()}
        assert flat.keys() == wflat.keys(), arch
        for k, v in flat.items():
            assert v.device.type == "meta"
            assert _spec(v) == (tuple(wflat[k].shape),
                                str(wflat[k].dtype)), (arch, k)


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """qwen3-0.6b's decode_32k and long_500k cells, run once into a tmp
    directory."""
    out = tmp_path_factory.mktemp("dryrun_torch")
    return out, {shape: D.run_cell("qwen3-0.6b", shape, "single", str(out))
                 for shape in ("decode_32k", "long_500k")}


def test_run_cell_decode_ok_and_long_skipped(cells):
    """qwen3-0.6b decode_32k counts ok on the 16 x 16 mesh (one rank's
    rows on the rank's shards of the weights: its heads, MLP columns and
    vocab block, so almost nothing is computed alike on every tp rank, and
    its per-device peak falls below that of the whole-weights step every tp
    rank would compute, counted on the tp-1 twin) and long_500k is skipped with the
    reference's reason; the records are written, and no group is left
    running."""
    import torch.distributed as dist
    out, recs = cells
    dec = recs["decode_32k"]
    dec, long_ = recs["decode_32k"], recs["long_500k"]
    assert not dist.is_initialized()
    assert dec["status"] == "ok", dec.get("traceback")
    assert dec["n_devices"] == 256 and dec["rows_per_rank"] == 8
    assert dec["roofline"]["dominant"] == "memory"
    twin = dec["tp1_twin"]
    assert dec["split_form"] and dec["replicated_over_tp"] <= 0.10
    assert dec["probes"][1]["flops"] < twin["flops"] / 8
    assert dec["probes"][1]["peak_bytes"] < twin["peak_bytes"] / 4
    assert dec["fits_80gb"] and dec["memory"]["how"] in ("full_depth",
                                                         "extrapolated")
    assert dec["memory"]["peak_bytes"] > dec["memory"]["resident_bytes"]
    assert dec["probes"][2]["flops"] > dec["probes"][1]["flops"] > 0
    assert 0 < dec["useful_flops_ratio"] < 1
    ok, why = jcfgs.applicable(jcfgs.get_config("qwen3-0.6b"), "long_500k")
    assert long_["status"] == "skipped" and long_["reason"] == why
    files = sorted(p.name for p in out.iterdir())
    assert files == ["qwen3-0.6b__decode_32k__single.json",
                     "qwen3-0.6b__long_500k__single.json"]
    assert json.loads((out / files[0]).read_text())["status"] == "ok"


def test_roofline_rows_over_artifacts(cells):
    """roofline_torch.rows() renders one row per artifact: the terms, the
    ratio, the peak and a hint for an ok cell, SKIP for a skipped one; the
    hint asks to split the model axis only of a step every tp rank
    computes whole (the cell as it read on whole weights)."""
    from benchmarks import roofline_torch
    out, recs = cells
    dec = recs["decode_32k"]
    rows = {r["name"]: r["derived"] for r in roofline_torch.rows(str(out))}
    assert set(rows) == {"roofline/qwen3-0.6b/decode_32k/single",
                         "roofline/qwen3-0.6b/long_500k/single"}
    ok = rows["roofline/qwen3-0.6b/decode_32k/single"]
    assert "dom=memory" in ok and "useful=" in ok and "fits_80gb=True" in ok
    assert "model axis" not in ok and "3.35 TB/s" in ok
    assert "model axis" in roofline_torch.hint(dict(dec,
                                                    replicated_over_tp=1.0))
    assert rows["roofline/qwen3-0.6b/long_500k/single"].startswith("SKIP: ")
    assert roofline_torch.rows(str(out / "none"))[0]["name"] == \
        "roofline/none"


#: the reference's _auto_microbatches at (256, 4096) over dp 16 and 32,
#: its _probe_cfg's n_layers at k = 1 and 2 and n_encoder_layers at 1, and
#: its _probe_units (src/repro/launch/dryrun.py:54-90)
REFERENCE_PROBES = {
    "qwen2-vl-7b": (4, 2, 1, 2, 0, 28), "jamba-v0.1-52b": (4, 2, 8, 16, 0, 4),
    "h2o-danube-1.8b": (2, 1, 1, 2, 0, 24), "qwen3-0.6b": (1, 1, 1, 2, 0, 28),
    "granite-3-2b": (2, 1, 1, 2, 0, 40), "qwen2-72b": (16, 8, 1, 2, 0, 80),
    "mixtral-8x7b": (4, 2, 1, 2, 0, 32),
    "qwen2-moe-a2.7b": (2, 1, 1, 2, 0, 24),
    "seamless-m4t-medium": (1, 1, 1, 2, 1, 12),
    "mamba2-780m": (2, 1, 1, 2, 0, 48)}


def test_microbatches_and_probes_match_reference_literals():
    assert set(REFERENCE_PROBES) == set(ARCHS)
    for arch, want in REFERENCE_PROBES.items():
        cfg = tcfgs.get_config(arch)
        p1, p2 = D._probe_cfg(cfg, 1), D._probe_cfg(cfg, 2)
        got = (D._auto_microbatches(cfg, 256, 4096, 16),
               D._auto_microbatches(cfg, 256, 4096, 32), p1.n_layers,
               p2.n_layers, p1.n_encoder_layers, D._probe_units(cfg))
        assert got == want, arch
        for p in (p1, p2):
            assert (p.unroll_layers, p.attn_chunk_q, p.attn_chunk_k) == \
                (True, 2048, 2048)
            assert p.ssd_probe_unroll == (cfg.family != "hybrid")


def test_train_cell_on_the_split_form(fake_group):
    """A train_4k-shaped cell of qwen3-0.6b's smoke config (8 rows of 64
    tokens) on a (2, 4) mesh of a fake group of 8 ranks: the trainer's
    step runs on the split form (its heads, MLP columns and vocab block at
    tp 4), almost none of its FLOPs are computed alike on every tp rank
    against the tp-1 twin (the step on whole weights), and its peak bytes
    a device fall below the twin's; its collectives are all-reduces over
    tp beside the dp gathers and reduce-scatters."""
    from repro_torch.configs.shapes import ShapeSpec
    cfg = tcfgs.config_for_shape(tcfgs.get_smoke_config("qwen3-0.6b"),
                                 "train_4k")
    shape = ShapeSpec("train_8x64", 64, 8, "train")
    fake_group(8)
    mesh = M.make_mesh((2, 4), ("data", "model"), device="meta")
    rec = D.measure(cfg, shape, lambda c: tcfgs.input_specs(
        c, "train_4k", reduced=(8, 64)), mesh, ("data",))
    twin = rec["tp1_twin"]
    assert rec["split_form"] and rec["rows_per_rank"] == 4
    assert abs(rec["replicated_over_tp"]) <= 0.05, rec["replicated_over_tp"]
    assert rec["probes"][1]["peak_bytes"] < twin["peak_bytes"]
    assert rec["probes"][1]["flops"] < twin["flops"] / 2
    counts = rec["probes"][1]["coll_count_by_op"]
    assert counts.get("all-reduce", 0) > 0 and counts.get("all-gather", 0) > 0
