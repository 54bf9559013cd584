"""The port's tensor-parallel train step (``Trainer`` on a mesh with tp >
1: each tp rank takes the loss and the gradients on its split form) against
the one-device port and the JAX reference.

Four gloo ranks (``tests/torch_tp_train_ranks.py``, one spawn with the 120
s hard timeout of ``tests/torch_mesh_ranks.py``) train the smoke configs
of qwen3-0.6b (tp 4 > Hkv 2: a KV head shared by two ranks, ``q_norm``
and ``k_norm`` whole), qwen2-moe-a2.7b (experts, shared experts, router),
mamba2-780m (SSM heads, B and C whole), jamba-v0.1-52b (all three) and
seamless-m4t-medium (encoder, self- and cross-attention) for two steps on
two ("data", "model") meshes, (1, 4) and (2, 2).  The weights and the
compute are f64 where the configs let them (the attention's softmax, the
router, the SSM scan and the cross entropy keep their f32), so the
comparison sees the split form's semantics and not f32's conditioning:
from f32 to f64 the one-device step-1 gradients move by up to 6.2e-4
(qwen2-moe), 1.5e-3 (jamba) and 6.3e-3 (seamless) of a leaf's max, more
than the tolerances below.

Held, per step and on the same weights (step 1 from the seed; step 2 from
the ranks' state after step 1, so that AdamW's first update, which turns
a gradient's last bits into a weight's sign, does not carry rounding into
the comparison): the loss and the grad norm the same on every rank and
within RTOL[arch] of the one-device trainer (the MoE archs' over the whole
batch in one microbatch, as the reference fills an expert's capacity over
every row at any dp; the others' of as many microbatches as the mesh has
dp ranks, the rows each dp rank takes), every gradient leaf of step 1
gathered whole within RTOL[arch] of the leaf's max |g|; the step-1 loss
within 1e-3 of the reference's ``Model.loss`` on the same weights over the
whole batch; each rank's tensors the cut ``tp_shard_params`` gives, the
state's and the split form's weights equal after the steps; the
all-reduces a step issues (at dp 2 the MoE blocks' count exchange
included), and no other collective; the MoE choices pinned across the two
sides.
"""
import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch_mesh_ranks as R  # noqa: E402
import torch_tp_train_ranks as TT  # noqa: E402

from repro.models import Model as JaxModel  # noqa: E402
from repro.models import ModelConfig as JaxConfig  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.parallel.sharding import tp_shard_params  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

torch.set_num_threads(2)

#: per-arch tolerances, relative: the archs with Mamba2 mixers or an
#: encoder at 1e-4, as the split form's serving is held to them
RTOL = {"qwen3-0.6b": 1e-5, "qwen2-moe-a2.7b": 1e-5, "mamba2-780m": 1e-4,
        "jamba-v0.1-52b": 1e-4, "seamless-m4t-medium": 1e-4}


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else v.detach().numpy()
            for k, v in tree.items()}


def _micro(shape, arch) -> int:
    """The microbatches of the one-device run a mesh of ``shape`` is held
    to: one for an MoE arch (its capacity is the whole batch's at any dp),
    the mesh's dp ranks for the others (a dp rank's rows, summed in the
    same order)."""
    return 1 if arch in TT.MOE else shape[0]


def _reference_losses(arch):
    """The reference's ``Model.loss`` (f32) on the seed's weights over the
    whole step-1 batch, which every mesh's step-1 loss is (an MoE arch's
    capacity couples the rows at dp 2 as at dp 1)."""
    cfg = TT.cfg_for(arch, "float32")
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), _numpy(
        Model(TT.cfg_for(arch), device="cpu", seed=0).param_tree()))
    batch = SyntheticLM(TT.cfg_for(arch), DataConfig(TT.B, TT.S)) \
        .global_batch(0)
    batch = {k: np.asarray(v) for k, v in batch.items()}
    batch = {k: jnp.asarray(v.astype(np.float32) if v.dtype.kind == "f"
                            else v) for k, v in batch.items()}
    loss = jax.jit(JaxModel(JaxConfig(**dataclasses.asdict(cfg))).loss)
    return float(loss(params, batch))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The one-device step 1 of each arch at the microbatches each mesh is
    held to (:func:`_micro`; the MoE archs' first), the 4-rank spawn (its
    MoE step-1 choices pinned to those), the others' and the reference's
    losses while it runs, then the one-device step 2 from each mesh's
    state after step 1, its MoE choices pinned to the ranks'."""
    def step_one(archs):
        runs = {}
        for a in archs:
            for n in {_micro(shape, a) for shape in TT.MESHES}:
                runs[(n, a)] = TT.run(a, microbatches=n, steps=(0,))
        return {(shape, a): runs[(_micro(shape, a), a)]
                for (n, a) in runs for shape in TT.MESHES
                if _micro(shape, a) == n}
    one = step_one(TT.MOE)
    pinned = {shape: {a: one[(shape, a)]["routes"][0] for a in TT.MOE}
              for shape in TT.MESHES}
    workdir = tmp_path_factory.mktemp("tp_train")
    handle = TT.spawn(workdir, pinned)
    deadline = time.monotonic() + R.SPAWN_TIMEOUT
    try:
        one.update(step_one(a for a in TT.ARCHS if a not in TT.MOE))
        ref = {a: _reference_losses(a) for a in TT.ARCHS}
    finally:
        R.wait(handle, deadline)
    ranks = R.load(workdir, "tp_train", 4)
    second = {}
    for shape in TT.MESHES:
        dp_lead = [i * shape[1] for i in range(shape[0])]  # tp index 0
        for a in TT.ARCHS:
            routes = TT.dp_joined([ranks[r][shape][a]["routes"][1]
                                   for r in dp_lead])
            second[(shape, a)] = TT.run(
                a, microbatches=_micro(shape, a), steps=(1,),
                start=ranks[0][shape][a]["state"][0],
                pins=(None, routes if a in TT.MOE else None))
    return {"one": one, "second": second, "ranks": ranks, "ref": ref}


def _same_on_every_rank(run, shape, arch, get):
    first = get(run["ranks"][0][shape][arch])
    for o in run["ranks"][1:]:
        assert get(o[shape][arch]) == first, (shape, arch)
    return first


@pytest.mark.parametrize("arch", TT.ARCHS)
def test_steps_match_one_device(run, arch):
    """Each step's loss and grad norm the same bits on every rank and within
    RTOL[arch] of the one-device trainer on the same weights and rows;
    every gradient leaf of step 1 (gathered whole) the same on every rank,
    bit for bit, and within RTOL[arch] of its max |g|."""
    tol = RTOL[arch]
    for shape in TT.MESHES:
        hist = _same_on_every_rank(run, shape, arch, lambda o: o["hist"])
        for step, want in enumerate((run["one"][(shape, arch)],
                                     run["second"][(shape, arch)])):
            np.testing.assert_allclose(hist[step], want["hist"][0], rtol=tol,
                                       atol=0, err_msg=f"{shape} {step}")
        got = run["ranks"][0][shape][arch]["grads"][0]
        for o in run["ranks"][1:]:
            for k, v in got.items():
                np.testing.assert_array_equal(o[shape][arch]["grads"][0][k],
                                              v)
        ref = run["one"][(shape, arch)]["grads"][0]
        assert got.keys() == ref.keys()
        for k, w in ref.items():
            err = np.abs(got[k] - w).max() / max(np.abs(w).max(), 1e-30)
            assert err <= tol, (shape, k, err)


def test_step_one_loss_matches_reference(run):
    """The step-1 loss within 1e-3 of the reference's ``Model.loss`` on the
    same weights over the whole batch (:func:`_reference_losses`)."""
    for shape in TT.MESHES:
        for arch in TT.ARCHS:
            got = run["ranks"][0][shape][arch]["hist"][0][0]
            want = run["ref"][arch]
            assert abs(got - want) < 1e-3, (shape, arch, got, want)


def test_each_rank_holds_its_shards(run):
    """A rank's model tensors are the cut ``tp_shard_params`` gives its
    (tp, index), so its bytes are what the split form predicts, below the
    whole model's by about tp; after the steps the split form's weights,
    gathered whole (``Model.whole_tree``), equal the gathered state, the
    same on every rank."""
    for shape in TT.MESHES:
        tp = shape[1]
        for arch in TT.ARCHS:
            model = Model(TT.cfg_for(arch), device="meta")
            whole = model.param_tree()
            total = sum(t.numel() for t in flatten(whole).values())
            for rank, o in enumerate(run["ranks"]):
                res = o[shape][arch]
                assert res["shard"] == (tp, rank % tp)
                want = {k: tuple(v.shape) for k, v in flatten(
                    tp_shard_params(model.cfg, whole, model.axes(), tp,
                                    rank % tp)).items()}
                assert res["shapes"] == want, (shape, arch)
                held = sum(int(np.prod(s)) for s in res["shapes"].values())
                assert held < total * (1.5 / tp), (shape, arch, held, total)
                for k, v in res["model"].items():
                    np.testing.assert_array_equal(v, res["params"][k],
                                                  err_msg=f"{shape} {arch}")
                    np.testing.assert_array_equal(
                        v, run["ranks"][0][shape][arch]["model"][k])


def _model_all_reduces(cfg, n_dp: int) -> int:
    """All-reduces the split form issues in a train step (remat "block",
    vocab, heads, MLP columns, experts and SSM heads all split): a row-
    parallel sum forward and a region's input backward for each attention
    (cross-attention: its query and its encoder K/V inputs), MLP and MoE
    block; the gated norm's sum both ways and ``w_out``'s sum forward, the
    input backward, for each Mamba2 block; each checkpointed unit's
    forward sums again in the recomputation, but its last (the
    recomputation stops at the last tensor the backward reads); the
    embedding's sum, the cross entropy's max and sum, and its input
    backward.  At ``n_dp`` > 1 each MoE block adds its count exchange over
    dp, in the forward and again in the recomputation."""
    def unit(kinds):
        fwd = sum({"attn": 1, "mamba": 2, "ffn": 1, "cross": 1}[k]
                  for k in kinds)
        bwd = sum({"attn": 1, "mamba": 2, "ffn": 1, "cross": 2}[k]
                  for k in kinds)
        return fwd + bwd + fwd - 1
    if cfg.family == "encdec":
        body = (cfg.n_encoder_layers * unit(["attn", "ffn"])
                + cfg.n_layers * unit(["attn", "cross", "ffn"]))
    else:
        kinds = []
        for i in range(cfg.layer_period):
            kinds.append(cfg.layer_kind(i))
            if cfg.layer_has_mlp(i):
                kinds.append("ffn")
        body = cfg.n_periods * unit(kinds)
    if n_dp > 1:
        body += 2 * cfg.n_periods * sum(cfg.layer_has_moe(i)
                                        for i in range(cfg.layer_period))
    return body + 1 + 3


def test_collectives_per_step(run):
    """Each step's collectives on every rank: the split form's all-reduces
    (:func:`_model_all_reduces`, at dp 2 the MoE blocks' count exchange)
    and the trainer's over tp, no all_gather or
    all_to_all; qwen3's trainer sums over tp ``q_norm``'s and ``k_norm``'s
    gradients, and at tp 4 > Hkv gathers ``wk`` and ``wv`` by an
    all-reduce and sums their gradients: 6 a step, 2 at tp 2; the dp
    reduce-scatters one a leaf, none over a dp group of one rank."""
    for shape in TT.MESHES:
        for arch in TT.ARCHS:
            cfg = TT.cfg_for(arch)
            n_leaves = len(flatten(Model(cfg, device="meta").param_tree()))
            for o in run["ranks"]:
                for calls in o[shape][arch]["calls"]:
                    own = calls["trainer"]["tp_all_reduce"]
                    assert calls["model"] == {
                        "all_to_all": 0, "all_gather": 0,
                        "all_reduce": _model_all_reduces(cfg, shape[0])
                        + own}, \
                        (shape, arch)
                    assert calls["trainer"]["reduce_scatter"] == (
                        n_leaves if shape[0] > 1 else 0)
                    if arch == "qwen3-0.6b":
                        assert own == (6 if shape[1] == 4 else 2), shape


def test_moe_choices_pinned(run):
    """The MoE archs' ranks took the one-device run's step-1 expert choices
    for their rows (of the whole batch's, each call), and the one-device
    step 2 the ranks' choices joined, every call of every MoE block
    (forward and recomputation); the flips each side's own choices would
    have made are counted (none at these shapes)."""
    for shape in TT.MESHES:
        for arch in TT.MOE:
            one = run["one"][(shape, arch)]["routes"][0]
            for rank, o in enumerate(run["ranks"]):
                res = o[shape][arch]
                dp_index = rank // shape[1]
                mine = TT.dp_share(one, shape[0], dp_index)
                assert len(res["routes"][0]) == len(mine) > 0
                for a, b in zip(res["routes"][0], mine):
                    np.testing.assert_array_equal(a, b)
                assert res["flips"] == [0, 0], (shape, arch)
            assert run["second"][(shape, arch)]["flips"] == [0]
