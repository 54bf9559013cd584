"""The port's training slice against the JAX reference on the CPU: the
synthetic data, the loss and its gradients, AdamW, the schedule,
microbatching, checkpoints crossing between the packages, and the
fault-tolerance pieces.

Tolerances (f32 unless named): ``lm_loss`` within rtol 1e-5 and every
gradient leaf within GRAD_TOL[arch] of max(1e-3, max |leaf|) of
``jax.value_and_grad(Model.loss)`` (the same arithmetic summed in another
order, through the reference's init): 1e-4 for qwen3-0.6b, 2e-3 for
seamless, whose f32 gradients both lie up to 5.7e-4 (the reference) and
9.0e-4 (the port) of that scale from a float64 run of the port, the
cross-attention K/V reaching ~30; one AdamW update's masters and
moments within rtol 1e-6 (bf16 params within one bf16 rounding step, as a
master a last bit apart may round the other way); the schedule, data and
checkpoints bit for bit; microbatching against the full batch as the
reference's own test (rtol 1e-3)."""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from conftest import tiny_dense_cfg  # noqa: E402
from repro.configs import get_smoke_config  # noqa: E402
from repro.data import DataConfig as JaxDataConfig  # noqa: E402
from repro.data import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw, schedules  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.train.fault_tolerance import (  # noqa: E402
    HeartbeatMonitor, StragglerDetector, WorkerFailure, elastic_restore,
    run_with_recovery)
from repro_torch.train.trainer import TrainConfig, Trainer  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402
from torch_decode_parity import port_cfg, seeded_params  # noqa: E402

torch.set_num_threads(2)


def _bits(x) -> np.ndarray:
    """A batch leaf's bits: bfloat16 (a torch tensor here, ml_dtypes there)
    as its 16-bit pattern."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


GRAD_TOL = {"qwen3-0.6b": 1e-4, "seamless-m4t-medium": 2e-3}


def test_synthetic_batches_bit_equal_to_the_reference():
    """Decoder, frontend (embeds in bf16) and enc-dec batches, with host
    sharding, bit for bit."""
    for arch, dtype in (("qwen3-0.6b", "float32"),
                        ("qwen2-vl-7b", "bfloat16"),
                        ("seamless-m4t-medium", "float32")):
        cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype=dtype)
        ours = SyntheticLM(port_cfg(cfg), DataConfig(4, 16, seed=7))
        ref = JaxSyntheticLM(cfg, JaxDataConfig(4, 16, seed=7))
        for step in (0, 13):
            got, want = ours.global_batch(step), ref.global_batch(step)
            assert sorted(got) == sorted(want), arch
            for k in want:
                np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]),
                                              err_msg=f"{arch} {k}")
                assert str(_bits(got[k]).dtype) == str(_bits(want[k]).dtype)
            part = ours.local_batch(step, 1, 2)
            np.testing.assert_array_equal(_bits(part["labels"]),
                                          _bits(want["labels"])[2:])


def _grad_batch(cfg, rng):
    data = SyntheticLM(port_cfg(cfg), DataConfig(2, 16, seed=3)).global_batch(0)
    data["mask"] = (rng.random(data["mask"].shape) < 0.8).astype(np.float32)
    return data


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "seamless-m4t-medium"])
def test_loss_and_every_gradient_match_jax(arch):
    cfg = dataclasses.replace(get_smoke_config(arch), attn_chunk_q=8,
                              attn_chunk_k=8)
    rng = np.random.default_rng(21)
    params_np = seeded_params(cfg, rng)
    batch = _grad_batch(cfg, rng)
    jbatch = {k: np.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(JaxModel(cfg).loss))(
        jax.tree.map(jnp.asarray, params_np), jbatch)
    model = from_jax_params(port_cfg(cfg), params_np, device="cpu")
    model.params.requires_grad_(True)
    got = model.loss({k: torch.as_tensor(v) for k, v in batch.items()})
    flat = flatten(model.param_tree())
    gots = torch.autograd.grad(got, list(flat.values()))
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    want = flatten(jax.tree.map(np.asarray, grads))
    assert list(want) == list(flat)
    for (path, w), g in zip(want.items(), gots):
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0,
            atol=GRAD_TOL[arch] * max(1e-3, float(np.abs(w).max())),
            err_msg=path)


def test_remat_modes_keep_loss_and_gradients():
    """``remat`` "block", "full" and "dots" (torch.utils.checkpoint) give
    the gradients of "none" exactly: recomputation repeats the same
    arithmetic."""
    cfg = dataclasses.replace(get_smoke_config("qwen3-0.6b"), remat="none")
    batch = {k: torch.as_tensor(v) for k, v in SyntheticLM(
        port_cfg(cfg), DataConfig(2, 16)).global_batch(0).items()}
    out = {}
    for mode in ("none", "block", "full", "dots"):
        model = Model(port_cfg(dataclasses.replace(cfg, remat=mode)),
                      device="cpu", seed=4)
        model.params.requires_grad_(True)
        flat = flatten(model.param_tree())
        loss = model.loss(batch)
        out[mode] = [loss] + list(torch.autograd.grad(loss,
                                                      list(flat.values())))
    for mode in ("block", "full", "dots"):
        for a, b in zip(out[mode], out["none"]):
            assert torch.equal(a, b), mode


def test_adamw_update_matches_jax_with_masters_and_clipping():
    """One bf16 update from a state past its first step (random moments and
    masters, step 3), gradients of norm ~16 against a clip of 1, and the
    warmup-cosine schedule, against ``repro.optim.adamw.update``."""
    from repro.optim import adamw as jax_adamw
    from repro.optim import schedules as jax_schedules
    rng = np.random.default_rng(22)
    shapes = {"a": (8, 6), "b": {"c": (5,), "d": (3, 4, 2)}}

    def draw(scale=1.0, positive=False):
        def leaf(s):
            x = rng.normal(size=s).astype(np.float32) * scale
            return np.abs(x) if positive else x
        return jax.tree.map(leaf, shapes, is_leaf=lambda s: isinstance(s, tuple))
    master, mu, nu, grads = draw(), draw(0.1), draw(0.01, True), draw(3.0)
    lr_args = (1e-2, 5, 20)
    jcfg = jax_adamw.AdamWConfig(lr=jax_schedules.warmup_cosine(*lr_args))
    pcfg = AdamWConfig(lr=schedules.warmup_cosine(*lr_args))
    jp = jax.tree.map(lambda w: jnp.asarray(w, jnp.bfloat16), master)
    jstate = {"step": jnp.asarray(3, jnp.int32),
              **{k: jax.tree.map(jnp.asarray, t) for k, t in
                 (("mu", mu), ("nu", nu), ("master", master))}}
    jgrads = jax.tree.map(lambda g: jnp.asarray(g, jnp.bfloat16), grads)
    jnew, jst, jm = jax_adamw.update(jcfg, jgrads, jstate, jp)

    def t(tree, dtype=torch.float32):
        return jax.tree.map(lambda a: torch.tensor(a).to(dtype), tree)
    pstate = {"step": torch.tensor(3, dtype=torch.int32), "mu": t(mu),
              "nu": t(nu), "master": t(master)}
    pnew, pst, pm = adamw.update(pcfg, t(grads, torch.bfloat16), pstate,
                                 t(master, torch.bfloat16))
    assert float(pm["grad_norm"]) > 4 * 1.0         # the clip bites
    np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(pm["lr"]), float(jm["lr"]), rtol=1e-7)
    assert int(pst["step"]) == int(jst["step"]) == 4
    for name in ("mu", "nu", "master"):
        for path, w in flatten(jax.tree.map(np.asarray, jst[name])).items():
            np.testing.assert_allclose(flatten(pst[name])[path].numpy(), w,
                                       rtol=1e-6, atol=1e-9, err_msg=path)
    for path, w in flatten(jax.tree.map(
            lambda a: np.asarray(a, np.float32), jnew)).items():
        got = flatten(pnew)[path]
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), w, rtol=2.0 ** -8,
                                   err_msg=path)


def test_warmup_cosine_at_its_edges_bit_for_bit():
    from repro.optim import schedules as jax_schedules
    for args in ((3e-3, 5, 10), (1e-2, 0, 4), (1.0, 3, 3)):
        ours = schedules.warmup_cosine(*args)
        ref = jax_schedules.warmup_cosine(*args)
        for step in (0, 1, args[1] - 1, args[1], args[1] + 1, args[2],
                     args[2] + 5):
            assert ours(step).dtype == torch.float32
            assert np.float32(ours(step).item()) == np.float32(ref(step)), (
                args, step)
    assert schedules.constant(0.5)(7).item() == 0.5


def test_microbatching_matches_full_batch():
    cfg = port_cfg(tiny_dense_cfg(vocab_size=64))
    data = SyntheticLM(cfg, DataConfig(global_batch=8, seq_len=16))
    results = []
    for mb in (1, 4):
        model = Model(cfg, device="cpu")
        trainer = Trainer(model, None, AdamWConfig(lr=1e-3),
                          TrainConfig(microbatches=mb))
        params, opt = trainer.init_state(seed=3)
        params, opt, hist = trainer.run(params, opt, iter(data), 3)
        results.append((hist, flatten(params)["b0/attn/wq"].detach().clone()))
    assert results[0][0][-1]["loss"] == pytest.approx(
        results[1][0][-1]["loss"], rel=1e-3)
    assert results[0][0][0]["grad_norm"] == pytest.approx(
        results[1][0][0]["grad_norm"], rel=1e-5)
    np.testing.assert_allclose(results[0][1].numpy(), results[1][1].numpy(),
                               rtol=1e-3, atol=1e-5)
    assert [h["step"] for h in results[1][0]] == [0, 1, 2]


def test_checkpoints_cross_between_the_packages_bit_for_bit(tmp_path):
    """A tree with bf16, f32 and int32 leaves written by each package
    restores in the other with the same bits and dtypes."""
    from repro.train.checkpoint import CheckpointManager as JaxCkpt
    rng = np.random.default_rng(23)
    w = rng.normal(size=(6, 4)).astype(np.float32)
    jtree = {"params": {"w": jnp.asarray(w, jnp.bfloat16),
                        "b": jnp.asarray(w[0])},
             "opt": {"step": jnp.asarray(7, jnp.int32)}}
    ttree = {"params": {"w": torch.tensor(w).to(torch.bfloat16),
                        "b": torch.tensor(w[0])},
             "opt": {"step": torch.tensor(7, dtype=torch.int32)}}
    JaxCkpt(str(tmp_path / "jax"), async_save=False).save(3, jtree)
    CheckpointManager(str(tmp_path / "torch"), async_save=False).save(3, ttree)
    got, step = CheckpointManager(str(tmp_path / "jax")).restore(ttree)
    assert step == 3
    want, step = JaxCkpt(str(tmp_path / "torch")).restore(jtree)
    assert step == 3
    for path, t in flatten(got).items():
        j = flatten(jax.tree.map(np.asarray, jtree))[path]
        assert t.dtype == flatten(ttree)[path].dtype, path
        np.testing.assert_array_equal(_bits(t), _bits(j), err_msg=path)
        back = flatten(jax.tree.map(np.asarray, want))[path]
        assert back.dtype == j.dtype, path
        np.testing.assert_array_equal(_bits(back), _bits(j), err_msg=path)


def test_checkpoint_atomic_commit_keep_and_elastic_restore(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    for s in (1, 2, 3, 4):
        ckpt.save(s, {"x": torch.full((8,), float(s))})
    ckpt.wait()
    assert ckpt.all_steps() == [3, 4]
    os.makedirs(os.path.join(str(tmp_path), "step_00000009.tmp"))
    assert ckpt.latest_step() == 4
    restored, step = ckpt.restore({"x": torch.zeros((8,))})
    assert step == 4 and float(restored["x"][0]) == 4.0
    moved, step = elastic_restore(ckpt, {"x": torch.zeros(8)}, "cpu")
    assert step == 4 and moved["x"].device.type == "cpu"


def test_run_with_recovery_after_an_injected_worker_failure(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), async_save=False)
    calls = {"n": 0}

    def train_chunk(state, start, n):
        calls["n"] += 1
        if calls["n"] == 2:            # injected failure mid-training
            raise WorkerFailure("node lost")
        return {"step_val": state["step_val"] + n}

    state, stats = run_with_recovery(
        train_chunk, {"step_val": torch.zeros(())}, ckpt,
        total_steps=30, ckpt_every=10)
    assert stats.restarts == 1
    assert stats.last_restored_step == 10
    assert float(state["step_val"]) == 30


def test_straggler_and_heartbeat_monitors():
    det = StragglerDetector(threshold=2.0, warmup=2)
    assert not any(det.observe(i, 1.0) for i in range(6))
    assert det.observe(6, 5.0) is True
    assert det.flagged == [(6, 5.0)]
    assert det.ewma == pytest.approx(1.0)
    t = {"now": 0.0}
    mon = HeartbeatMonitor(["w0", "w1"], deadline_s=10.0,
                           clock=lambda: t["now"])
    t["now"] = 5.0
    mon.beat("w0")
    assert mon.healthy()
    t["now"] = 12.0
    assert mon.failed_workers() == ["w1"]
    assert not mon.healthy()
