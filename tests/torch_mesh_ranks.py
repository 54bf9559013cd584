"""Rank bodies of ``tests/test_torch_distributed.py``, run in spawned gloo
processes, and the spawner.

The module imports the port, torch and numpy only (no JAX, no reference
package): each rank body drives the port over a process group and saves
what it saw with :func:`save`; the test, in the parent process, holds
those results against the reference's.  Every spawn has a hard timeout
(:data:`SPAWN_TIMEOUT`) and every group the port's 60 s collective
timeout, so a rank that raises cannot leave the others blocked past it;
the spawner kills whatever is still alive when it gives up.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

#: seconds a spawn may take in all before its ranks are killed
SPAWN_TIMEOUT = 120

#: the reference's mesh tests' small decoder (tests/test_distributed.py:300)
DECODER = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=8,
               n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128,
               kv_page_slots=4, param_dtype="float32",
               compute_dtype="float32")
#: scattered frames of tests/test_distributed.py:322, and its batch
FRAMES, B, S = [5, 2, 11, 7, 3, 13, 1, 9], 2, 8
#: the reference's sharded-training test (tests/test_distributed.py:90):
#: its model, DataConfig(8, 16), AdamWConfig(lr=1e-3), 3 steps from seed 0
TRAIN = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=64,
             param_dtype="float32", compute_dtype="float32")
TRAIN_B, TRAIN_S, TRAIN_LR, TRAIN_STEPS = 8, 16, 1e-3, 3
#: the meshes the 4 ranks train on, ("data", "model")
TRAIN_MESHES = ((4, 1), (2, 2))
#: and a mesh with two data-parallel dims, ("pod", "data", "model")
TRAIN_POD = (2, 2, 1)


# ---------------------------------------------------------------------------
# Spawning
# ---------------------------------------------------------------------------
def _entry(rank, fn, world, store, args_path):
    torch.set_num_threads(1)
    with open(args_path, "rb") as f:
        args = pickle.load(f)
    from repro_torch.launch.mesh import init_process_group
    init_process_group("cpu", rank=rank, world_size=world,
                       init_method=f"file://{store}")
    try:
        fn(rank, *args)
    finally:
        from repro_torch.parallel import mesh_ctx
        mesh_ctx.clear_context()
        dist.destroy_process_group()


def start(fn, world: int, workdir, *args):
    """Start ``fn(rank, *args)`` on ``world`` gloo ranks (a ``FileStore``
    under ``workdir``); returns the handle :func:`wait` takes.  The
    arguments travel in a file: a spawn pickle larger than a pipe's buffer
    would start the ranks one after another."""
    base = os.path.join(str(workdir), fn.__name__)
    with open(base + ".args", "wb") as f:
        pickle.dump(args, f)
    return mp.start_processes(_entry, args=(fn, world, base + ".store",
                                            base + ".args"),
                              nprocs=world, join=False, start_method="spawn")


def wait(handle, deadline: float) -> None:
    """Join every rank by the monotonic ``deadline``; a rank that raised
    re-raises here (the others are terminated), and ranks still alive at
    the deadline are killed."""
    try:
        while not handle.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                raise TimeoutError("spawned ranks outlived their timeout")
    finally:
        for p in handle.processes:
            if p.is_alive():
                p.kill()
                p.join(5)


def save(workdir, name: str, rank: int, obj) -> None:
    with open(os.path.join(str(workdir), f"{name}_rank{rank}.pkl"), "wb") as f:
        pickle.dump(obj, f)


def load(workdir, name: str, world: int) -> list:
    out = []
    for rank in range(world):
        with open(os.path.join(str(workdir), f"{name}_rank{rank}.pkl"),
                  "rb") as f:
            out.append(pickle.load(f))
    return out


# ---------------------------------------------------------------------------
# Inputs, made from seeds by numpy (the test makes the same ones)
# ---------------------------------------------------------------------------
def emem_inputs(n_shards: int, seed: int) -> dict:
    """A logical store of 1024 slots of 4 in pages of 16, a write batch of
    32 requests per shard with duplicates inside one requester's chunk and
    across chunks, and a read batch of 32 per shard, every other one an
    address the write batch wrote (read-after-write across ranks)."""
    rng = np.random.default_rng(seed)
    r = 32 * n_shards
    waddr = rng.integers(0, 1024, r).astype(np.int32)
    waddr[1:3] = waddr[0]                       # within chunk 0
    waddr[-1] = waddr[-5] = waddr[0]            # in the last chunk too
    waddr[33 % r] = waddr[4]                    # across chunks 0 and 1
    raddr = rng.integers(0, 1024, r).astype(np.int32)
    raddr[::2] = waddr[::-2]
    return {"logical": rng.normal(size=(64, 16, 4)).astype(np.float32),
            "waddr": waddr,
            "wvals": rng.normal(size=(r, 4)).astype(np.float32),
            "raddr": raddr}


#: (name, mesh shape, mesh dims, kv axes) of the EMem / EMemVM cases
MESHES = {4: [("data4", (4, 1), ("data", "model"), ("data",)),
              ("pod2x2", (2, 2, 1), ("pod", "data", "model"),
               ("pod", "data")),
              ("data2_tp2", (2, 2), ("data", "model"), ("data",))],
          2: [("data2", (2, 1), ("data", "model"), ("data",))]}


# ---------------------------------------------------------------------------
# Rank bodies
# ---------------------------------------------------------------------------
def _emem_case(spec, group, x, cf):
    """Round trip, write then read (the rank's chunks), on this rank's
    block: returns the logical stores and the rank's read values."""
    from repro_torch.core import emem
    r, s = dist.get_rank(group), spec.n_shards
    logical = torch.tensor(x["logical"])
    block = emem.from_logical(spec, logical, group=group)
    back = emem.to_logical(spec, block, group=group)
    chunk = slice(r * 32, (r + 1) * 32)
    emem.write(spec, block, torch.tensor(x["waddr"][chunk]),
               torch.tensor(x["wvals"][chunk]), cf, group=group)
    got = emem.read(spec, block, torch.tensor(x["raddr"][chunk]), cf,
                    group=group)
    return {"roundtrip": back.numpy(),
            "written": emem.to_logical(spec, block, group=group).numpy(),
            "read": got.numpy(), "n_shards": s, "rank": r}


class _Pair:
    """The mesh VM and its one-process twin, driven in lockstep: every
    vread bit-equal."""

    def __init__(self, cfg, mesh, kv):
        from repro_torch.emem_vm import EMemVM
        self.vm = EMemVM(cfg, device="cpu", mesh=mesh, axes=kv)
        self.twin = EMemVM(cfg, sharded=True, device="cpu")

    def __getattr__(self, name):
        def call(*args):
            got = getattr(self.vm, name)(*args)
            want = getattr(self.twin, name)(*args)
            if name == "vread":
                np.testing.assert_array_equal(got.numpy(), want.numpy())
                return got.numpy()
            assert got == want, name
            return got
        return call

    def check(self, spec):
        from repro_torch.core import emem
        vm = self.vm
        assert vm.counters() == self.twin.counters()
        assert vm.stats() == self.twin.stats()
        store = emem.to_logical(spec, vm.data, group=vm.group).numpy()
        np.testing.assert_array_equal(
            store, emem.to_logical(spec, self.twin.data).numpy())
        return store


def _vm_oracle_run(cfg, mesh, kv, seed):
    """tests/test_distributed.py:183-230 on the pair: vwrite / vread
    against a physical mirror through the translation, before and after
    unmap and a remap that recycles frames."""
    pair, ps, w = _Pair(cfg, mesh, kv), cfg.spec.page_slots, cfg.spec.width
    rng = np.random.default_rng(seed)
    mirror = np.zeros((cfg.spec.n_slots, w), np.float32)
    pair.map_range(0, 24)

    def xlate(addrs):
        pt = pair.vm.page_table
        ok = np.array([pt.is_mapped(a // ps) for a in addrs])
        phys = np.array([pt.frame_of(a // ps) * ps + a % ps if o else 0
                         for a, o in zip(addrs, ok)])
        return phys, ok

    def rounds(n):
        for _ in range(n):
            addrs = rng.choice(48 * ps, 64, replace=False).astype(np.int32)
            vals = rng.normal(size=(64, w)).astype(np.float32)
            phys, ok = xlate(addrs)
            pair.vwrite(torch.tensor(addrs), torch.tensor(vals))
            mirror[phys[ok]] = vals[ok]
            got = pair.vread(torch.tensor(addrs))
            np.testing.assert_array_equal(
                got, np.where(ok[:, None], mirror[phys], 0))
    rounds(2)
    for vp in range(0, 24, 2):
        pair.unmap_page(vp)
    pair.map_range(30, 10)
    rounds(2)
    pair.check(cfg.spec)
    return pair.vm.counters()


def _vm_swap_run(cfg, mesh, kv, seed):
    """tests/test_distributed.py:233-294 on the pair: swap-outs release
    frames, reads and a write fault them back, unmapped pages still read
    zeros and drop writes.  Returns the flushed logical store, the
    translation and the logical oracle, for the reference's read_ref."""
    pair, ps, w = _Pair(cfg, mesh, kv), cfg.spec.page_slots, cfg.spec.width
    rng = np.random.default_rng(seed)
    pair.map_range(0, 12)
    addrs = torch.arange(12 * ps, dtype=torch.int32)
    logical = rng.normal(size=(12, ps, w)).astype(np.float32)
    pair.vwrite(addrs, torch.tensor(logical.reshape(-1, w)))
    free0 = pair.vm.allocator.free_count()
    for vp in range(0, 12, 2):
        pair.swap_out(vp)
    assert pair.vm.allocator.free_count() == free0 + 6
    np.testing.assert_array_equal(pair.vread(addrs), logical.reshape(-1, w))
    assert pair.vm.page_table.swapped_count() == 0
    assert pair.vm.counters()["swap_ins"] == 6
    pair.swap_out(1)
    logical[1] = rng.normal(size=(ps, w)).astype(np.float32)
    pair.vwrite(torch.arange(ps, 2 * ps, dtype=torch.int32),
                torch.tensor(logical[1]))
    pair.flush()
    store = pair.check(cfg.spec)
    un = torch.arange(20 * ps, 21 * ps, dtype=torch.int32)
    assert not pair.vread(un).any()
    pair.vwrite(un, torch.tensor(logical[1]))
    assert not pair.vread(un).any()
    return {"store": store, "logical": logical,
            "frames": [pair.vm.page_table.frame_of(vp) for vp in range(12)]}


def _memory(world):
    """(b) EMem and (c) EMemVM over every mesh of ``MESHES[world]``."""
    from repro_torch.core import emem
    from repro_torch.emem_vm import VMConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import mesh_ctx
    out = {}
    for name, shape, dims, kv in MESHES[world]:
        mesh = make_mesh(shape, dims, "cpu")
        group = mesh_ctx.axes_group(mesh, kv)
        n = dist.get_world_size(group)
        spec = emem.EMemSpec(n_slots=1024, width=4, page_slots=16,
                             n_shards=n)
        x = emem_inputs(n, seed=n)
        out[name] = {cf: _emem_case(spec, group, x, cf)
                     for cf in (float(n), 0.5)}
        swap_spec = dataclasses.replace(spec, n_slots=512)
        for sets in (0, 4):
            seed = 10 * n + sets
            out[name][f"vm{sets}"] = {
                "oracle": _vm_oracle_run(
                    VMConfig(spec=spec, n_vpages=48, cache_sets=sets), mesh,
                    kv, seed),
                "swap": _vm_swap_run(
                    VMConfig(spec=swap_spec, n_vpages=24, cache_sets=sets),
                    mesh, kv, seed)}
    return out


def two_ranks(rank, workdir, params, spill_cases):
    """(b) and (c) on 2 ranks, then (e)'s spill tier served on a (2, 1)
    mesh with ``spill_path``."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import mesh_ctx
    out = {"memory": _memory(2)}
    mesh_ctx.set_context(make_host_mesh(device="cpu"))
    model = _decoder("pooled", params)
    out["serve"] = {name: serve(model, case)
                    for name, case in spill_cases.items()}
    save(workdir, "two", rank, out)


def _decoder(layout, params, pool=16):
    from repro_torch.models.config import ModelConfig
    from repro_torch.weights import from_jax_params
    cfg = ModelConfig(**DECODER, kv_layout=layout,
                      kv_pool_pages=pool if layout == "pooled" else None)
    return from_jax_params(cfg, params, device="cpu")


def decode_logits(model, toks):
    """tests/test_distributed.py:297-346's decode from scratch of ``toks``
    [B, <= S]: for pooled, host tables with the scattered FRAMES; logits
    of every step."""
    frames = iter(FRAMES)
    cache = model.init_cache(B, 16)
    bt = np.full((B, 4), -1, np.int32)
    fl = np.zeros(16, np.int32)
    lengths = torch.zeros(B, dtype=torch.int32)
    out = []
    for t in range(toks.shape[1]):
        lengths = lengths + 1
        if model.cfg.kv_layout == "pooled":
            for b in range(B):
                if bt[b, t // 4] < 0:
                    f = next(frames)
                    bt[b, t // 4], fl[f] = f, t // 4
            cache["vm"] = {"block_table": torch.tensor(bt),
                           "frame_lpage": torch.tensor(fl),
                           "frame_ro": torch.zeros(16, dtype=torch.bool)}
        logits, cache = model.decode_step(torch.tensor(toks[:, t:t + 1]),
                                          cache, lengths)
        out.append(logits.numpy())
    return np.stack(out)


@dataclasses.dataclass
class ServeCase:
    """One engine run of the serving tests."""
    prompts: list
    pool: int
    share: bool = False
    host: int | None = None
    spill: int = 0
    spill_path: str | None = None
    fused: int = 1


def serve(model, case: ServeCase):
    """Serve ``case.prompts`` (6 new tokens each) on ``model`` under the
    installed context; returns (per-uid tokens, shutdown stats, spill dir)."""
    from repro_torch.serve import EngineConfig, Request, Scheduler, ServeEngine
    cfg = dataclasses.replace(model.cfg, kv_pool_pages=case.pool)
    with ServeEngine(model.with_config(cfg), EngineConfig(
            slots=5, max_len=32, preempt_mode="swap", host_frames=case.host,
            spill_frames=case.spill, spill_path=case.spill_path,
            max_fused_steps=case.fused)) as eng:
        eng.blocks.share_prefixes = case.share
        spill = eng.blocks.spill
        spill_dir = spill.path if spill is not None else None
        sched = Scheduler(eng)
        sched.submit([Request(uid=i, prompt=p, max_new_tokens=6)
                      for i, p in enumerate(case.prompts)])
        done = sched.run()
    return {r.uid: tuple(r.output) for r in done}, eng.shutdown(), spill_dir


def train(mesh, device="cpu", dp_axes=("data",)):
    """TRAIN's 3 steps on ``mesh`` (None: one device) with ``fsdp_tp`` over
    ``dp_axes``: (trainer, params, opt, per-step losses and grad norms)."""
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.model import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.trainer import TrainConfig, Trainer
    cfg = ModelConfig(**TRAIN)
    trainer = Trainer(Model(cfg, device=device), mesh,
                      AdamWConfig(lr=TRAIN_LR), TrainConfig(dp_axes=dp_axes))
    params, opt = trainer.init_state(seed=0)
    data = SyntheticLM(cfg, DataConfig(TRAIN_B, TRAIN_S))
    params, opt, hist = trainer.run(params, opt, iter(data), TRAIN_STEPS)
    return trainer, params, opt, [(h["loss"], h["grad_norm"]) for h in hist]


def whole(tree) -> dict:
    """{path: numpy} of a state tree, DTensor leaves gathered (every rank
    together)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.tree import flatten
    return {k: (v.full_tensor() if isinstance(v, DTensor) else v)
            .detach().numpy().copy() for k, v in flatten(tree).items()}


def _train_on_meshes(workdir) -> dict:
    """Training on each of TRAIN_MESHES and on TRAIN_POD (dp over "pod"
    and "data"), with the model's weights gathered whole (at tp > 1 its
    tensors are the rank's split form: ``Model.whole_tree``); the (4, 1)
    state saved to ``workdir/ckpt`` by the async saver and restored by
    elastic_restore onto the (2, 2) mesh's shardings."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.fault_tolerance import elastic_restore
    from repro_torch.tree import flatten
    out, trainers = {}, {}
    for shape in TRAIN_MESHES:
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        trainer, params, opt, hist = train(mesh)
        trainers[shape] = trainer
        out[shape] = {"hist": hist,
                      "model": whole(trainer.model.whole_tree()),
                      "state": whole({"params": params, "opt": opt}),
                      "local": {k: tuple(v.to_local().shape)
                                for k, v in flatten(params).items()}}
        if shape == (4, 1):
            ckpt = CheckpointManager(os.path.join(str(workdir), "ckpt"))
            ckpt.save(TRAIN_STEPS, {"params": params, "opt": opt})
            ckpt.wait()
    mesh = make_mesh(TRAIN_POD, ("pod", "data", "model"), "cpu")
    trainer, params, _, hist = train(mesh, dp_axes=("pod", "data"))
    out["pod"] = {"hist": hist, "model": whole(trainer.model.whole_tree()),
                  "local": {k: tuple(v.to_local().shape)
                            for k, v in flatten(params).items()}}
    tr = trainers[(2, 2)]
    like = {"params": tr.params_sh, "opt": tr.opt_sh}
    restored, step = elastic_restore(
        CheckpointManager(os.path.join(str(workdir), "ckpt")), like, like)
    leaves = flatten(restored)
    out["restored"] = {
        "step": step, "state": whole(restored),
        "dtensor": all(isinstance(v, DTensor) for v in leaves.values()),
        "placements_equal": all(
            v.placements == flatten(like)[k].placements
            for k, v in leaves.items())}
    return out


def four_ranks(rank, workdir, params, toks, cases):
    """(b) and (c) on 4 ranks, then (d) decode and (e) serving on a
    (2 kv x 2 tp) mesh, then training on TRAIN_MESHES."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import mesh_ctx
    out = {"memory": _memory(4)}
    mesh_ctx.set_context(make_host_mesh(tp=2, device="cpu"),
                         batch_axes=("data",), tp_axis="model",
                         kv_axes=("data",))
    out["decode"] = {layout: decode_logits(_decoder(layout, params), toks)
                     for layout in ("pooled", "paged")}
    model = _decoder("pooled", params)
    try:                       # 15 pages do not split over 2 kv ranks
        _decoder("pooled", params, pool=15).init_cache(B, 16)
    except ValueError:
        out["odd_pool_refused"] = True
    out["serve"] = {name: serve(model, case) for name, case in cases.items()}
    mesh_ctx.clear_context()
    out["train"] = _train_on_meshes(workdir)
    save(workdir, "four", rank, out)
