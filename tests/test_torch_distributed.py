"""The port across ranks against the JAX reference.

Correctness across ranks comes from gloo process groups on the CPU: the
rank bodies (``tests/torch_mesh_ranks.py``, which imports the port only)
run in spawned processes with a hard timeout, save what they saw, and the
tests hold it against the reference's one-device results (the
reference's own mesh tests show its results do not depend on the mesh;
it does not run on a mesh here), against ``repro.core.emem._plan`` for
the drops, and against the port's one-process forms:

(a) the sharding specs against ``repro.parallel.sharding`` (no spawn);
(b) EMem over 2 and 4 ranks, kv axes ``("data",)`` and ``("pod",
    "data")``: bit-equal to the emulated form and to ``read_ref`` /
    ``write_ref``, drops exactly where ``_plan`` says;
(c) EMemVM on the same meshes, bit-equal to ``EMemVM(sharded=True)``
    step by step, its resident bytes the reference's ``read_ref`` through
    the translation;
(d) pooled and paged decode on a (2 kv x 2 tp) mesh: logits within 1e-4
    of the port's single-device path and 1e-3 of the reference's batch
    layout (its own bound), the same on every rank; a world-1 context
    equals the no-context path bit for bit;
(e) serving on that mesh (swap, COW) and the spill tier with a path at 2
    ranks, stepwise and fused: tokens per uid the reference engine's and
    the same on every rank.
"""
import dataclasses
import functools
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch_mesh_ranks as R  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.core import emem as jax_emem  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import ModelConfig as JaxConfig  # noqa: E402
from repro.parallel import sharding as jax_shd  # noqa: E402
from repro.serve import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import Scheduler as JaxScheduler  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.core import emem  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402

torch.set_num_threads(2)


class _Mesh:
    """Stands in for a mesh: axis sizes by name."""

    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))


MESHES = [((1, 1), ("data", "model")), ((2, 2), ("data", "model")),
          ((4, 2), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))]


@pytest.fixture(scope="module")
def arch_shapes():
    """Three archs' smoke configs: (axes, param shapes, cache shapes of the
    batch and pooled layouts), by ``jax.eval_shape``."""
    out = {}
    for arch in ("qwen3-0.6b", "qwen2-moe-a2.7b", "jamba-v0.1-52b"):
        model = JaxModel(get_smoke_config(arch))
        caches = [jax.eval_shape(lambda m=m: m.init_cache(4, 32)) for m in (
            JaxModel(dataclasses.replace(model.cfg, kv_layout=layout,
                                         kv_page_slots=4, kv_pool_pages=32))
            for layout in ("batch", "pooled"))]
        out[arch] = (model.axes(),
                     jax.eval_shape(model.init, jax.random.key(0)), caches)
    return out


def _tuples(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))


@pytest.mark.parametrize("rules", ["fsdp_tp", "tp_only", "dp_only"])
def test_sharding_specs_match_reference(rules, arch_shapes):
    """(a) Every parameter's spec (with and without shapes), the batch spec
    and every cache leaf's spec, for three archs' smoke configs on four
    mesh shapes, equal the reference's PartitionSpecs."""
    for shape, axes in MESHES:
        mesh = _Mesh(shape, axes)
        dp = tuple(a for a in axes if a != "model")
        want_rules = jax_shd.rule_set(rules, dp)
        assert sharding.rule_set(rules, dp) == want_rules
        assert sharding.batch_spec(want_rules) == tuple(
            jax_shd.batch_spec(want_rules))
        kw = dict(dp_axes=dp, tp_axis="model", kv_axes=dp)
        for arch, (param_axes, shapes, caches) in arch_shapes.items():
            for tree in (None, shapes):
                assert sharding.params_pspecs(
                    param_axes, want_rules, mesh, tree) == _tuples(
                    jax_shd.params_pspecs(param_axes, want_rules, mesh,
                                          tree)), (arch, shape)
            for cache in caches:
                assert sharding.cache_pspecs(cache, mesh, **kw) == _tuples(
                    jax_shd.cache_pspecs(cache, mesh, **kw)), (arch, shape)


def _port_emulated(n, x, cf):
    """The port's one-process emulated form on the inputs of one case."""
    spec = emem.EMemSpec(n_slots=1024, width=4, page_slots=16, n_shards=n)
    phys = emem.from_logical(spec, torch.tensor(x["logical"]))
    emem.write(spec, phys, torch.tensor(x["waddr"]),
               torch.tensor(x["wvals"]), cf)
    got = emem.read(spec, phys, torch.tensor(x["raddr"]), cf)
    return emem.to_logical(spec, phys).numpy(), got.numpy()


@functools.partial(jax.jit, static_argnums=(0, 1))
def _reference_memory(n, cap, logical, waddr, wvals, raddr):
    """The reference's single view: ``write_ref`` then ``read_ref``, and
    ``_plan``'s valid bits of each requester's chunk of ``raddr``."""
    spec = jax_emem.EMemSpec(n_slots=1024, width=4, page_slots=16,
                             n_shards=n)
    store = jax_emem.write_ref(spec, logical, waddr, wvals)
    valid = jax.vmap(lambda a: jax_emem._plan(spec, a, cap).valid)(
        raddr.reshape(n, -1))
    return store, jax_emem.read_ref(spec, store, raddr), valid


def _expect_memory(world):
    """What (b) expects of every mesh the ranks run, computed while they
    run: the emulated form's logical store after the write and its reads,
    held here to the reference (``write_ref``/``read_ref`` without drops,
    ``_plan``'s drops at factor 0.5)."""
    by_n = {}
    for name, *_ in R.MESHES[world]:
        n = 4 if name in ("data4", "pod2x2") else 2
        if n in by_n:
            continue
        x = R.emem_inputs(n, seed=n)
        by_n[n] = {"n": n, "x": x}
        for cf in (float(n), 0.5):
            written, read = by_n[n][cf] = _port_emulated(n, x, cf)
            cap = emem.capacity_for(emem.EMemSpec(1024, 4, 16, n_shards=n),
                                    32, cf)
            store, want, valid = (np.asarray(a) for a in _reference_memory(
                n, cap, *(jnp.asarray(x[k]) for k in
                          ("logical", "waddr", "wvals", "raddr"))))
            if cf >= n:        # no drop: the reference's single view
                np.testing.assert_array_equal(written, store)
                np.testing.assert_array_equal(read, want)
                continue
            assert not valid.all(axis=1).any(), "cf=0.5 should overflow"
            np.testing.assert_array_equal(read, np.where(
                valid.reshape(-1, 1),
                written.reshape(1024, 4)[x["raddr"]], 0))
    return {name: by_n[4 if name in ("data4", "pod2x2") else 2]
            for name, *_ in R.MESHES[world]}


def _check_memory(outs, expected):
    """(b) and (c) of every mesh the ranks ran."""
    swap_spec = jax_emem.EMemSpec(n_slots=512, width=4, page_slots=16)
    for name, want in expected.items():
        cases = [o["memory"][name] for o in outs]
        for cf in (float(want["n"]), 0.5):
            written, read = want[cf]
            for case in cases:
                res = case[cf]
                assert res["n_shards"] == want["n"]
                np.testing.assert_array_equal(res["roundtrip"],
                                              want["x"]["logical"])
                np.testing.assert_array_equal(res["written"], written)
                chunk = slice(res["rank"] * 32, (res["rank"] + 1) * 32)
                np.testing.assert_array_equal(res["read"], read[chunk])
        for sets in (0, 4):
            runs = [c[f"vm{sets}"] for c in cases]
            assert all(r["oracle"] == runs[0]["oracle"] for r in runs)
            swap = runs[0]["swap"]
            for r in runs[1:]:
                np.testing.assert_array_equal(r["swap"]["store"],
                                              swap["store"])
            # the resident bytes through the translation, by read_ref
            slots = (np.asarray(swap["frames"])[:, None] * 16
                     + np.arange(16)).reshape(-1)
            got = jax_emem.read_ref(swap_spec, jnp.asarray(swap["store"]),
                                    jnp.asarray(slots))
            np.testing.assert_array_equal(np.asarray(got),
                                          swap["logical"].reshape(-1, 4))


@pytest.fixture(scope="module")
def reference():
    """The reference decoder, its weights, and the inputs of (d) and (e):
    tokens, the swap trace's prompts and the prefix-sharing trace's
    (tests/test_distributed.py:349)."""
    cfg = JaxConfig(**R.DECODER, kv_layout="pooled")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128, int(rng.integers(3, 8))).astype(np.int32)
               for _ in range(5)]
    system = rng.integers(0, 128, 9).astype(np.int32)
    shared = [np.concatenate([system,
                              rng.integers(0, 128, 2).astype(np.int32)])
              for _ in range(3)]
    toks = np.random.default_rng(0).integers(0, 128, (R.B, R.S))
    model = JaxModel(cfg)
    params = model.init(jax.random.key(0))
    return {"prompts": prompts, "shared": shared, "toks": toks,
            "params": jax.tree.map(np.array, params), "model": model,
            "jax_params": params}


def _reference_results(ref):
    """The reference's one-device results: the batch layout's logits at
    every decode step of ``toks``, and the engine's tokens per uid for the
    swap and prefix-sharing traces."""
    model, params = ref["model"], ref["jax_params"]
    mb = JaxModel(dataclasses.replace(model.cfg, kv_layout="batch"))
    cache = mb.init_cache(R.B, 16)
    step = jax.jit(mb.decode_step)
    logits = []
    for t in range(R.S):
        lg, cache = step(params, jnp.asarray(ref["toks"][:, t:t + 1]), cache,
                         jnp.full((R.B,), t + 1, jnp.int32))
        logits.append(np.asarray(lg))
    tokens = {}
    # one roomy pool and stepwise dispatch for both: the reference's tokens
    # depend on neither (tests/test_distributed.py:393,
    # tests/test_fused_decode.py), and one configuration compiles once
    m = JaxModel(dataclasses.replace(model.cfg, kv_pool_pages=64))
    for name, prompts, share in (("swap", ref["prompts"], False),
                                 ("cow", ref["shared"], True)):
        with JaxServeEngine(m, params, JaxEngineConfig(
                slots=5, max_len=32, preempt_mode="swap",
                max_fused_steps=1)) as eng:
            eng.blocks.share_prefixes = share
            sched = JaxScheduler(eng)
            sched.submit([JaxRequest(uid=i, prompt=p, max_new_tokens=6)
                          for i, p in enumerate(prompts)])
            done = sched.run()
        tokens[name] = {r.uid: tuple(r.output) for r in done}
    return np.stack(logits), tokens


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, reference):
    """The two spawns, run at once: 4 ranks for (b) and (c), then (d) and
    (e) on (2 kv x 2 tp); 2 ranks for (b) and (c), then the spill tier.
    The reference's results, the emulated form's and the single-device
    decode are made here while the ranks run."""
    ref = reference
    four, two = (tmp_path_factory.mktemp(n) for n in ("four", "two"))
    cases = {}
    for fused in (1, 4):
        tag = "" if fused == 1 else "_fused"
        cases["swap" + tag] = R.ServeCase(ref["prompts"], 12, fused=fused)
        cases["cow" + tag] = R.ServeCase(ref["shared"], 24, share=True,
                                         fused=fused)
    spill_path = str(two / "spill")
    spill = {name: R.ServeCase(ref["prompts"], 12, host=2, spill=32,
                               spill_path=spill_path, fused=fused)
             for name, fused in (("swap_spill", 1), ("swap_spill_fused", 4))}
    handles = (R.start(R.four_ranks, 4, four, four, ref["params"],
                       ref["toks"], cases),
               R.start(R.two_ranks, 2, two, two, ref["params"], spill))
    logits, tokens = _reference_results(ref)
    expected = {n: _expect_memory(n) for n in (4, 2)}
    single = {layout: R.decode_logits(R._decoder(layout, ref["params"]),
                                      ref["toks"])
              for layout in ("pooled", "paged")}
    deadline = time.monotonic() + R.SPAWN_TIMEOUT
    try:
        R.wait(handles[0], deadline)
    finally:
        R.wait(handles[1], deadline)
    return {"four": R.load(four, "four", 4), "two": R.load(two, "two", 2),
            "expected": expected, "logits": logits, "tokens": tokens,
            "single": single, "cases": cases, "spill": spill,
            "spill_path": spill_path}


def _check_serving(outs, want, stats_check):
    """Every run's tokens per uid are the reference's on every rank, its
    stats the same on every rank, no frame leaked."""
    for name, check in stats_check.items():
        runs = [o["serve"][name] for o in outs]
        for tokens, stats, _ in runs:
            assert tokens == want[name.split("_")[0]], name
            assert stats["leaked_frames"] == 0, name
            check(stats)
        assert all(r[1] == runs[0][1] for r in runs), name


@pytest.mark.parametrize("world", [4, 2])
def test_emem_and_vm_over_ranks(ranks, world):
    """(b) and (c) on 4 ranks -- kv axes ("data",) over 4, ("pod", "data")
    over 2 x 2, ("data",) over 2 replicated over a tp axis of 2 -- and on
    2 ranks, ("data",) over 2."""
    _check_memory(ranks["four" if world == 4 else "two"],
                  ranks["expected"][world])


def test_decode_on_a_2x2_mesh(ranks):
    """(d) on (2 kv x 2 tp): pooled decode over scattered frames and paged
    decode over the identity tables; every step's logits the same on every
    rank, within 1e-4 of the single-device path and 1e-3 of the
    reference's batch layout; a pool that does not split over the kv
    ranks is refused."""
    outs = ranks["four"]
    assert all(o.get("odd_pool_refused") for o in outs)
    for layout, want in ranks["single"].items():
        got = outs[0]["decode"][layout]
        for o in outs[1:]:
            np.testing.assert_array_equal(o["decode"][layout], got)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        err = np.abs(got[..., :128] - ranks["logits"][..., :128]).max()
        assert err < 1e-3, (layout, err)


def test_serving_on_ranks(ranks):
    """(e) swap and COW serving on (2 kv x 2 tp), and the spill tier on 2
    ranks with a bounded host store (2 frames) demoting into a spill store
    under ``spill_path``, stepwise and fused; each rank spills under its
    own subdirectory."""
    def swapped(stats):
        assert stats["swapped"] > 0 and stats["swap_resumed"] > 0

    def shared(stats):
        assert stats["cow_copies"] > 0 and stats["shared_tokens"] > 0

    def spilled(stats):
        assert stats["swapped"] > 0 and stats["spill_out_pages"] > 0
        assert stats["spill_in_pages"] > 0, "no two-hop promotion"
    _check_serving(ranks["four"], ranks["tokens"],
                   {name: swapped if name.startswith("swap") else shared
                    for name in ranks["cases"]})
    _check_serving(ranks["two"], ranks["tokens"],
                   {name: spilled for name in ranks["spill"]})
    path = ranks["spill_path"]
    assert {o["serve"][name][2] for o in ranks["two"]
            for name in ranks["spill"]} == {f"{path}/rank0", f"{path}/rank1"}


def test_world_one_context_equals_single_device(tmp_path, reference,
                                               arch_shapes, monkeypatch):
    """(d) at world 1 (the card's world): under a (1, 1) context the rank
    body equals the no-context path bit for bit, on the pooled decode and
    through a served trace; EMem's group form at one shard equals the
    one-shard store, which never drops; the group starts with gloo only
    because the CPU is named, and the store's placements are the
    reference's sharding."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.parallel import mesh_ctx
    out = reference
    pooled = R._decoder("pooled", out["params"])
    plain = R.decode_logits(pooled, out["toks"])
    case = R.ServeCase(out["prompts"], 12, fused=4)
    plain_serve = R.serve(pooled, case)
    assert launch_mesh.backend_for("cpu") == "gloo"
    with monkeypatch.context() as m:      # no GPU: no fallback to gloo
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            launch_mesh.backend_for(None)
    launch_mesh.init_process_group(
        "cpu", rank=0, world_size=1, init_method=f"file://{tmp_path}/store")
    try:
        mesh = launch_mesh.make_host_mesh(device="cpu")
        ctx = mesh_ctx.set_context(mesh)
        assert (ctx.n_kv_shards, ctx.tp, ctx.kv_index, ctx.tp_index) == (
            1, 1, 0, 0)
        mesh_ctx.reset_calls()
        np.testing.assert_array_equal(R.decode_logits(pooled, out["toks"]),
                                      plain)
        # 2 layers x 8 steps: 2 all_reduce and 1 all_gather each
        assert mesh_ctx.CALLS == {"all_to_all": 0, "all_reduce": 32,
                                  "all_gather": 16}
        tokens, stats, _ = R.serve(pooled, case)
        assert tokens == plain_serve[0] and stats == plain_serve[1]
        spec = emem.EMemSpec(n_slots=1024, width=4, page_slots=16)
        x = R.emem_inputs(1, seed=1)
        group = mesh_ctx.axes_group(mesh, ("data",))
        block = emem.from_logical(spec, torch.tensor(x["logical"]),
                                  group=group)
        emem.write(spec, block, torch.tensor(x["waddr"]),
                   torch.tensor(x["wvals"]), 0.5, group=group)
        got = emem.read(spec, block, torch.tensor(x["raddr"]), 0.5,
                        group=group)
        written, read = _port_emulated(1, x, 0.5)
        np.testing.assert_array_equal(block.numpy(), written)
        np.testing.assert_array_equal(got.numpy(), read)
        # the exchange alone at one shard (the card's all_to_all check):
        # at a capacity of the whole batch it cannot drop, so it equals
        # the shortcut
        mesh_ctx.reset_calls()
        cap = emem.capacity_for(spec, 32, 1.0)
        np.testing.assert_array_equal(emem.read_exchange(
            spec, group, block, torch.tensor(x["raddr"]), cap).numpy(), read)
        emem.write_exchange(spec, group, block, torch.tensor(x["waddr"]),
                            torch.tensor(x["wvals"]) + 1, cap)
        shortcut = emem.write(spec, torch.tensor(written),
                              torch.tensor(x["waddr"]),
                              torch.tensor(x["wvals"]) + 1)
        np.testing.assert_array_equal(block.numpy(), shortcut.numpy())
        assert mesh_ctx.CALLS["all_to_all"] == 4
        assert emem.sharding_for(spec, mesh, ("data",)) == (Shard(0),
                                                            Replicate())
        assert sharding.placements((None, ("data", "model")), mesh) == (
            Shard(1), Shard(1))
        # params_shardings: the qwen3 smoke config's specs as placements,
        # which DTensor takes (fsdp_tp: the embedding [vocab, embed] is
        # ("model", "data"))
        axes, shapes, _ = arch_shapes["qwen3-0.6b"]
        placed = sharding.params_shardings(
            axes, sharding.rule_set("fsdp_tp"), mesh, shapes)
        assert placed["embed"]["tok"] == (Shard(1), Shard(0))
        from torch.distributed.tensor import distribute_tensor
        shape = tuple(shapes["embed"]["tok"].shape)
        emb = distribute_tensor(torch.zeros(shape), mesh,
                                placed["embed"]["tok"])
        assert tuple(emb.shape) == shape
        with pytest.raises(ValueError, match="mesh order"):
            sharding.placements((("model", "data"),), mesh)
    finally:
        mesh_ctx.clear_context()
        torch.distributed.destroy_process_group()
