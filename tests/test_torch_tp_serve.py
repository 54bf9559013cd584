"""The port's tensor-parallel split form (``Model.shard``) served over ranks,
against the one-device port and the JAX reference.

Four gloo ranks (``tests/torch_tp_ranks.py``, one spawn with the 120 s
hard timeout of ``tests/torch_mesh_ranks.py``) serve the reference's small
mesh decoder (8 heads, 2 KV heads of 16) and two small MoE decoders (E 4:
the experts split over tp; E 3: their columns, and the shared expert's)
in the split form, each rank holding its own heads, MLP columns, experts
and vocab block, on two ("data", "model") meshes: (1, 4), where tp 4 > Hkv
2 puts each rank's 2 query heads inside a KV-head group of 4 (the paged
step takes them on the composed path on the CPU, K1/K2 on a card), and
(2, 2), one whole group a rank with the pages over 2 kv ranks.  Held:

* every rank's logits equal every other's, within 1e-4 of the one-device
  port and 1e-3 of the reference's batch-layout decode on the same numpy
  params (tests/test_distributed.py:80-84), on the batch, paged and
  pooled layouts, in prefill and in both MoE splits;
* a seeded swap trace served by the split form on the pooled layout,
  stepwise and fused, gives the reference engine's tokens;
* each rank holds 1/tp of every split weight (of the KV heads the one its
  query heads read at tp > Hkv), the rest whole;
* the collectives a step calls: 2 a layer plus 2 on the batch layout.
"""
import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch_mesh_ranks as R  # noqa: E402
import torch_tp_ranks as TP  # noqa: E402

from repro.models import Model as JaxModel  # noqa: E402
from repro.models import ModelConfig as JaxConfig  # noqa: E402
from repro.serve import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import Scheduler as JaxScheduler  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

torch.set_num_threads(2)

PORT_ATOL, REF_ATOL = 1e-4, 1e-3
VOCAB = R.DECODER["vocab_size"]


def _jax_cfg(layout="batch", **kw):
    return JaxConfig(**{**R.DECODER, **kw}, kv_layout=layout)


def _ref_logits(model, params, toks, prefill=False):
    """The reference's batch-layout logits at every decode step of toks
    [S, B, V]; with ``prefill`` also those of its prefill of all but the
    last token into a 16-position cache and of one decode step of the last
    [2, B, V] (the same jitted step)."""
    mb = JaxModel(dataclasses.replace(model.cfg, kv_layout="batch"))
    cache = mb.init_cache(R.B, 16)
    step = jax.jit(mb.decode_step)
    out = []
    for t in range(R.S):
        lg, cache = step(params, jnp.asarray(toks[:, t:t + 1]), cache,
                         jnp.full((R.B,), t + 1, jnp.int32))
        out.append(np.asarray(lg))
    if not prefill:
        return np.stack(out)
    first, cache = jax.jit(mb.prefill, static_argnums=2)(
        params, {"tokens": jnp.asarray(toks[:, :-1])}, 16)
    last, _ = step(params, jnp.asarray(toks[:, -1:]), cache,
                   jnp.full((R.B,), R.S, jnp.int32))
    return np.stack(out), np.stack([np.asarray(first), np.asarray(last)])


def _ref_tokens(model, params, prompts):
    with JaxServeEngine(
            JaxModel(dataclasses.replace(model.cfg, kv_layout="pooled",
                                         kv_pool_pages=64)), params,
            JaxEngineConfig(slots=5, max_len=32, preempt_mode="swap",
                            max_fused_steps=1)) as eng:
        sched = JaxScheduler(eng)
        sched.submit([JaxRequest(uid=i, prompt=p, max_new_tokens=6)
                      for i, p in enumerate(prompts)])
        done = sched.run()
    return {r.uid: tuple(r.output) for r in done}


def _numpy_params(cfg, seed):
    """A seeded weight tree as numpy, the reference's param layout (drawn
    by the port, which is faster than the reference's init here)."""
    def tree(t):
        return {k: tree(v) if isinstance(v, dict) else v.numpy()
                for k, v in t.items()}
    return tree(Model(cfg, device="cpu", seed=seed).param_tree())


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The 4-rank spawn, and meanwhile the reference's and the one-device
    port's results on the same params."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, VOCAB, int(rng.integers(3, 8))).astype(np.int32)
               for _ in range(5)]
    toks = np.random.default_rng(0).integers(0, VOCAB, (R.B, R.S))
    params = _numpy_params(TP.dense_cfg("batch"), 0)
    moe_params = {case: _numpy_params(TP.moe_cfg(case), 1) for case in TP.MOE}
    workdir = tmp_path_factory.mktemp("tp")
    handle = TP.spawn(workdir, params, moe_params, toks, prompts)
    deadline = time.monotonic() + R.SPAWN_TIMEOUT
    try:
        dense = JaxModel(_jax_cfg())
        jparams = jax.tree.map(jnp.asarray, params)
        ref = {"decode": _ref_logits(dense, jparams, toks),
               "tokens": _ref_tokens(dense, jparams, prompts),
               "moe": {}}
        for case, p in moe_params.items():
            ref["moe"][case] = dict(zip(("decode", "prefill"), _ref_logits(
                JaxModel(_jax_cfg(**TP.MOE_BASE, **TP.MOE[case])),
                jax.tree.map(jnp.asarray, p), toks, prefill=True)))
        one = {"decode": {}, "moe": {}}
        for layout in ("batch", "paged", "pooled"):
            one["decode"][layout] = R.decode_logits(from_jax_params(
                TP.dense_cfg(layout), params, device="cpu"), toks)
        whole = from_jax_params(TP.dense_cfg("batch"), params, device="cpu")
        one["prefill"] = TP.prefill_logits(whole, toks)
        one["shapes"] = TP.shapes(whole)
        for case, p in moe_params.items():
            m = from_jax_params(TP.moe_cfg(case), p, device="cpu")
            one["moe"][case] = {"decode": R.decode_logits(m, toks),
                                "prefill": TP.prefill_logits(m, toks),
                                "shapes": TP.shapes(m)}
    finally:
        R.wait(handle, deadline)
    return {"ranks": R.load(workdir, "tp", 4), "ref": ref, "one": one}


def _same_on_every_rank(outs, get):
    first = get(outs[0])
    for o in outs[1:]:
        for a, b in zip(np.atleast_1d(get(o)), np.atleast_1d(first)):
            np.testing.assert_array_equal(a, b)
    return first


def _close(got, port, ref, what):
    np.testing.assert_allclose(got, port, rtol=0, atol=PORT_ATOL,
                               err_msg=what)
    err = np.abs(got[..., :VOCAB] - ref[..., :VOCAB]).max()
    assert err < REF_ATOL, (what, err)


@pytest.mark.parametrize("shape", TP.MESHES)
def test_split_decode_logits(run, shape):
    """Batch, paged and pooled decode of the split form: the same logits on
    every rank, the one-device port's within 1e-4, the reference's batch
    layout within 1e-3."""
    outs = [o[shape] for o in run["ranks"]]
    for layout in ("batch", "paged", "pooled"):
        got = _same_on_every_rank(outs, lambda o: o["decode"][layout])
        _close(got, run["one"]["decode"][layout], run["ref"]["decode"],
               f"{shape} {layout}")


@pytest.mark.parametrize("shape", TP.MESHES)
def test_split_prefill_logits(run, shape):
    """Prefill of the first S - 1 tokens (K3's plain path on the rank's
    heads) into the rank's batch cache, then a decode step over it: the
    one-device port's logits within 1e-4, and within 1e-3 the reference's
    batch-layout decode of the same positions."""
    outs = [o[shape] for o in run["ranks"]]
    got = _same_on_every_rank(outs, lambda o: o["prefill"])
    ref = run["ref"]["decode"][-2:]          # the same positions decoded
    for i, what in enumerate(("prefill", "decode after prefill")):
        _close(got[i], run["one"]["prefill"][i], ref[i], f"{shape} {what}")


@pytest.mark.parametrize("case", list(TP.MOE))
def test_split_moe(run, case):
    """The MoE decoders in the split form on both meshes (E 4: experts
    split over tp 4 and 2; E 3: every expert's columns and the shared
    expert's): decode logits, and the prefill's with the decode step
    after it (their capacity, and so their drops, differ from decode's),
    held as the dense decoder's."""
    for shape in TP.MESHES:
        outs = [o[shape]["moe"][case] for o in run["ranks"]]
        one, ref = run["one"]["moe"][case], run["ref"]["moe"][case]
        for key in ("decode", "prefill"):
            got = _same_on_every_rank(outs, lambda o: o[key])
            _close(np.stack(got), np.stack(one[key]), ref[key],
                   f"{case} {shape} {key}")


def test_split_serving_tokens(run):
    """A seeded 5-request swap trace on the pooled layout (12 pages, 5
    slots), stepwise and fused 4 steps a run: the reference engine's
    tokens per uid on every rank of both meshes, no frame leaked."""
    for shape in TP.MESHES:
        for o in run["ranks"]:
            for fused, (tokens, stats) in o[shape]["serve"].items():
                assert tokens == run["ref"]["tokens"], (shape, fused)
                assert stats["leaked_frames"] == 0
                assert stats["swapped"] > 0, (shape, fused)


def _split_dim(path, shape, experts_split=False):
    """The dim tp splits of the weight at ``path``, or None (whole)."""
    leaf = path.split("/")[-1]
    if leaf == "tok":
        return 0
    if "router" in path or "shared_gate" in path or leaf == "w":
        return None
    if "moe/w_" in path and experts_split:
        return 1
    return len(shape) - (2 if leaf in ("wo", "w_down") else 1)


def _check_shards(whole_shapes, local_shapes, tp, experts_split=False):
    """1/tp of each split dim; of the KV heads 1/min(tp, Hkv): at tp > Hkv
    a rank holds the one KV head its query heads read."""
    hkv = R.DECODER["n_kv_heads"]
    for path, whole in whole_shapes.items():
        local = local_shapes[path]
        dim = _split_dim(path, whole, experts_split)
        part = min(tp, hkv) if path.split("/")[-1] in ("wk", "wv") else tp
        want = tuple(n // part if i == dim else n
                     for i, n in enumerate(whole))
        assert local == want, (path, whole, local, tp)


def test_each_rank_holds_its_shards(run):
    """Every split weight is 1/tp of the whole along one dim: the heads'
    columns (whole heads; at tp 4 one KV head of the 2, 1/2) and ``wo``'s
    rows,
    the MLP columns and ``w_down``'s rows, the experts (E 4) or every
    expert's columns and the shared expert's (E 3), the vocab rows; the
    router, the shared gate and the norms stay whole.  The shard records
    (tp, index); a second split and a split without a context raise."""
    one = run["one"]
    for shape in TP.MESHES:
        tp = shape[1]
        for rank, o in enumerate(run["ranks"]):
            res = o[shape]
            assert res["shard"] == (tp, rank % tp)
            assert res["reshard_refused"]
            _check_shards(one["shapes"], res["shapes"], tp)
            for case in TP.MOE:
                _check_shards(one["moe"][case]["shapes"],
                              res["moe"][case]["shapes"], tp,
                              experts_split=case == "experts")
    assert all(o["no_context_refused"] for o in run["ranks"])


def test_collectives_per_step(run):
    """Calls a decode step makes over the groups (2 layers): on the batch
    layout 2 all_reduces a layer (after ``wo``, after ``w_down``) plus the
    embedding's all_reduce and the logits' all_gather; on the paged layouts
    also a layer's gather of the rank's k/v heads over tp (the page
    replica takes every KV head's row) and the kv merge's two calls.
    The prefill: the same 2 a layer plus 2, once."""
    layers = R.DECODER["n_layers"]
    for shape in TP.MESHES:
        for o in run["ranks"]:
            calls = o[shape]["calls"]
            per = {k: {op: n / R.S for op, n in c.items()}
                   for k, c in calls.items()}
            assert per["batch"] == {"all_to_all": 0, "all_reduce":
                                    2 * layers + 1, "all_gather": 1}
            for layout in ("paged", "pooled"):
                assert per[layout] == {
                    "all_to_all": 0, "all_reduce": 4 * layers + 1,
                    "all_gather": layers + 1}, (shape, layout)
            assert o[shape]["prefill_calls"] == {
                "all_to_all": 0, "all_reduce": 2 * (2 * layers + 1),
                "all_gather": 2}
