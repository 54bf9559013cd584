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
    the same on every rank;
(f) training (``Trainer`` on a mesh, FSDP over "data" and the state's
    tensor-parallel shards over "model") on (4, 1) and (2, 2) meshes of
    the 4 ranks: every step's loss the same on every rank, within rtol
    1e-5 of the port's one-device trainer and 1e-3 of the reference's
    (its own bound, tests/test_distributed.py:90), the gathered weights
    within 1e-4 of one device's; the (4, 1) checkpoint restored by
    ``elastic_restore`` onto the (2, 2) mesh and onto one device bit for
    bit.  The training runs in the 4-rank spawn, after (e).
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
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.configs import get_smoke_config as port_smoke  # noqa: E402
from repro_torch.configs import list_archs  # noqa: E402
from repro_torch.core import emem  # noqa: E402
from repro_torch.models import layers as port_layers  # noqa: E402
from repro_torch.models.model import Model, defs_for  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.train.fault_tolerance import elastic_restore  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

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


def _port_axes_match_reference():
    """The port's ``Model.axes()`` (smoke configs) and its defs' axes (full
    configs) equal the reference's ``Model.axes()`` for all ten archs; the
    port's ``Model.shapes()`` gives the reference's shapes."""
    from repro.configs import get_config
    for arch in list_archs():
        model = Model(port_smoke(arch), device="cpu")
        ref = JaxModel(get_smoke_config(arch))
        assert model.axes() == ref.axes(), arch
        assert jax.tree.map(lambda t: tuple(t.shape), model.shapes()) == \
            jax.tree.map(lambda t: tuple(t.shape), ref.shapes()), arch
        assert port_layers.build_axes(defs_for(port_config(arch))) == \
            JaxModel(get_config(arch)).axes(), arch


@pytest.mark.parametrize("rules", ["fsdp_tp", "tp_only", "dp_only"])
def test_sharding_specs_match_reference(rules, arch_shapes):
    """(a) Every parameter's spec (with and without shapes), the batch spec
    and every cache leaf's spec, for three archs' smoke configs on four
    mesh shapes, equal the reference's PartitionSpecs, the parameters'
    specs taken from the port's own ``Model.axes()`` and ``Model.shapes()``,
    which equal the reference's for all ten archs."""
    if rules == "fsdp_tp":
        _port_axes_match_reference()
    for shape, axes in MESHES:
        mesh = _Mesh(shape, axes)
        dp = tuple(a for a in axes if a != "model")
        want_rules = jax_shd.rule_set(rules, dp)
        assert sharding.rule_set(rules, dp) == want_rules
        assert sharding.batch_spec(want_rules) == tuple(
            jax_shd.batch_spec(want_rules))
        kw = dict(dp_axes=dp, tp_axis="model", kv_axes=dp)
        for arch, (param_axes, shapes, caches) in arch_shapes.items():
            port = Model(port_smoke(arch), device="cpu")
            for tree, ours in ((None, None), (shapes, port.shapes())):
                assert sharding.params_pspecs(
                    port.axes(), want_rules, mesh, ours) == _tuples(
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


def _training_references():
    """(f)'s one-device runs: the port's ``Trainer`` (per-step losses and
    grad norms, the final weights) and the reference's ``Trainer`` on a
    one-device mesh from the port's initial weights (per-step losses)."""
    from repro.data import DataConfig as JaxDataConfig
    from repro.data import SyntheticLM as JaxSyntheticLM
    from repro.launch.mesh import make_host_mesh as jax_host_mesh
    from repro.optim import AdamWConfig as JaxAdamW
    from repro.train.trainer import Trainer as JaxTrainer
    from repro_torch.models.config import ModelConfig
    init = Model(ModelConfig(**R.TRAIN), device="cpu", seed=0).param_tree()
    trainer, _, _, hist = R.train(None)
    jcfg = JaxConfig(**R.TRAIN)
    jt = JaxTrainer(JaxModel(jcfg), jax_host_mesh(),
                    JaxAdamW(lr=R.TRAIN_LR))
    params, opt = jt.init_state(seed=0)
    params = jax.device_put(
        jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()), init),
        jt.params_sh)
    data = JaxSyntheticLM(jcfg, JaxDataConfig(R.TRAIN_B, R.TRAIN_S))
    _, _, jhist = jt.run(params, opt, iter(data), R.TRAIN_STEPS)
    return {"hist": hist, "model": R.whole(trainer.model.param_tree()),
            "jax_loss": [h["loss"] for h in jhist]}


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
    training = _training_references()
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
            "spill_path": spill_path, "training": training,
            "ckpt_dir": str(four / "ckpt")}


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


def _nest(flat: dict) -> dict:
    """{"a/b": x} -> {"a": {"b": x}}."""
    out: dict = {}
    for path, leaf in flat.items():
        *keys, last = path.split("/")
        node = out
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


@pytest.mark.parametrize("shape", R.TRAIN_MESHES)
def test_sharded_training_matches_single_device(ranks, shape):
    """(f) Three steps of the reference test's model on a ("data",
    "model") mesh of ``shape`` (with (4, 1) also a (2, 2, 1) ("pod",
    "data", "model") mesh, data-parallel over "pod" and "data"): each rank
    holds its shards (wq's [layers, embed, q_heads] split over the data
    axes and model), every step's loss and grad norm the same on every
    rank and within rtol 1e-5 of the port's one-device trainer, the loss
    within 1e-3 of the reference's, the gathered weights (the model's
    tensors) the same on every rank, equal to the gathered state and
    within 1e-4 of one device's."""
    one = ranks["training"]
    runs = {"": [o["train"][shape] for o in ranks["four"]]}
    if shape == (4, 1):
        runs["pod"] = [o["train"]["pod"] for o in ranks["four"]]
    for name, group in runs.items():
        hist = group[0]["hist"]
        assert group[0]["local"]["b0/attn/wq"] == (2, 64 // shape[0],
                                                   64 // shape[1]), name
        for run in group:
            assert run["hist"] == hist, name
            for k, v in group[0]["model"].items():
                np.testing.assert_array_equal(run["model"][k], v, err_msg=k)
                if "state" in run:
                    np.testing.assert_array_equal(
                        run["state"][f"params/{k}"], v, err_msg=k)
        np.testing.assert_allclose(np.array(hist), np.array(one["hist"]),
                                   rtol=1e-5, atol=0, err_msg=name)
        err = np.abs(np.array([l for l, _ in hist]) - one["jax_loss"]).max()
        assert err < 1e-3, (name, err)
        for k, v in one["model"].items():
            np.testing.assert_allclose(group[0]["model"][k], v, rtol=0,
                                       atol=1e-4, err_msg=f"{name} {k}")


def test_elastic_restore_across_meshes(ranks):
    """(f) The (4, 1) mesh's state (params, moments, step), written by rank
    0 through the async saver, restored by ``elastic_restore`` onto the
    (2, 2) mesh's shardings (DTensors placed as the (2, 2) trainer places
    them) and onto one device, bit for bit."""
    saved = ranks["four"][0]["train"][(4, 1)]["state"]
    for out in ranks["four"]:
        train = out["train"]
        for k, v in saved.items():
            np.testing.assert_array_equal(train[(4, 1)]["state"][k], v)
        got = train["restored"]
        assert got["step"] == R.TRAIN_STEPS
        assert got["dtensor"] and got["placements_equal"]
        assert got["state"].keys() == saved.keys()
        for k, v in saved.items():
            np.testing.assert_array_equal(got["state"][k], v, err_msg=k)
    ckpt = CheckpointManager(ranks["ckpt_dir"])
    assert ckpt.all_steps() == [R.TRAIN_STEPS]
    like = _nest({k: torch.zeros(()) for k in saved})
    one, step = elastic_restore(ckpt, like, "cpu")
    assert step == R.TRAIN_STEPS
    for k, v in flatten(one).items():
        assert v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), saved[k], err_msg=k)


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
        assert placed["embed"]["tok"].placements == (Shard(1), Shard(0))
        shape = tuple(shapes["embed"]["tok"].shape)
        emb = placed["embed"]["tok"].place(torch.zeros(shape))
        assert tuple(emb.shape) == shape
        assert emb.placements == (Shard(1), Shard(0))
        # (f) at world 1: a (1, 1) mesh trains bit for bit as one device,
        # and its async checkpoint restores onto one device bit for bit
        mesh_ctx.clear_context()
        trainer, params, opt, hist = R.train(mesh)
        alone, _, _, alone_hist = R.train(None)
        assert hist == alone_hist
        mine = R.whole(trainer.model.param_tree())
        for k, v in R.whole(alone.model.param_tree()).items():
            np.testing.assert_array_equal(mine[k], v, err_msg=k)
        ckpt = CheckpointManager(str(tmp_path / "ckpt"))
        ckpt.save(R.TRAIN_STEPS, {"params": params, "opt": opt})
        ckpt.wait()
        state = R.whole({"params": params, "opt": opt})
        one, _ = elastic_restore(ckpt, _nest({k: 0 for k in state}), "cpu")
        for k, v in flatten(one).items():
            np.testing.assert_array_equal(v.numpy(), state[k], err_msg=k)
        with pytest.raises(ValueError, match="mesh order"):
            sharding.placements((("model", "data"),), mesh)
    finally:
        mesh_ctx.clear_context()
        torch.distributed.destroy_process_group()
