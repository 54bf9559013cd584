"""The port's tensor-parallel split form (``Model.shard``) of the Mamba2
mixers and the encoder-decoder, served over ranks, against the one-device
port and the JAX reference.

Four gloo ranks (``tests/torch_tp_mixers_ranks.py``, one spawn with the
120 s hard timeout of ``tests/torch_mesh_ranks.py``) serve the smoke
configs of mamba2-780m (8 SSM heads of 32, N 16), jamba-v0.1-52b (8
layers: one attention layer of 4 heads over 2 KV heads, 7 Mamba2 layers of
8 heads, 4 MoE layers of 4 experts) and seamless-m4t-medium (4 heads) in
the split form, each rank holding its SSM heads with their channels, its
attention heads, MLP columns, experts and vocab block, on two ("data",
"model") meshes: (1, 4) and (2, 2).  Held:

* every rank's logits equal every other's, within 1e-4 of the one-device
  port and 1e-3 of the reference on the same numpy params (both relative
  to the larger of 1 and the largest |logit|, as ``test_torch_ssm.py``
  holds this config's SSM paths: its SSD state runs into the thousands):
  the decoders' decode on the batch layout (jamba's on the pooled at tp 4
  > Hkv), their prefill followed by a decode step, seamless's
  ``prepare_cross_cache`` and decode steps;
* a seeded swap trace of jamba on the pooled layout, served by the split
  form, gives the reference engine's tokens;
* each rank holds its heads' z/x/dt columns, conv channels, ``norm_w``,
  ``w_out`` rows and ``a_log``/``dt_bias``/``d_skip`` with B and C whole,
  its prefill states are the one-device port's on those channels and
  heads, and seamless's caches hold its KV heads; every registered arch
  splits;
* the collectives a step calls: two a Mamba2 layer, three a seamless
  decoder layer, plus the embedding's and the logits'.
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
import torch_tp_mixers_ranks as TM  # noqa: E402

from repro.models import Model as JaxModel  # noqa: E402
from repro.models import ModelConfig as JaxConfig  # noqa: E402
from repro.models import encdec as jax_E  # noqa: E402
from repro.serve import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import Scheduler as JaxScheduler  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.configs import list_archs  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

torch.set_num_threads(2)

PORT_RTOL, REF_RTOL = 1e-4, 1e-3
JAMBA = "jamba-v0.1-52b"


def _jax_cfg(arch, layout="batch", pool=16):
    return JaxConfig(**dataclasses.asdict(TM.cfg_for(arch, layout, pool)))


def _numpy_params(cfg, seed):
    """A seeded weight tree as numpy, the reference's param layout (drawn
    by the port, which is faster than the reference's init here)."""
    def tree(t):
        return {k: tree(v) if isinstance(v, dict) else v.numpy()
                for k, v in t.items()}
    return tree(Model(cfg, device="cpu", seed=seed).param_tree())


def _ref_decoder(arch, params):
    """The reference's batch-layout logits at every decode step of
    ``toks_for(arch)``, and those of its prefill of all but the last token
    into a 16-position cache and of one decode step of the last."""
    toks = TM.toks_for(arch)
    b, s = toks.shape
    mb = JaxModel(_jax_cfg(arch))
    cache = mb.init_cache(b, 16)
    step = jax.jit(mb.decode_step)
    out = []
    for t in range(s):
        lg, cache = step(params, jnp.asarray(toks[:, t:t + 1]), cache,
                         jnp.full((b,), t + 1, jnp.int32))
        out.append(np.asarray(lg))
    first, cache = jax.jit(mb.prefill, static_argnums=2)(
        params, {"tokens": jnp.asarray(toks[:, :-1])}, 16)
    last, _ = step(params, jnp.asarray(toks[:, -1:]), cache,
                   jnp.full((b,), s, jnp.int32))
    return {"decode": np.stack(out),
            "prefill": (np.asarray(first), np.asarray(last))}


def _ref_encdec(params):
    toks, embeds = TM.toks_for(TM.ENCDEC), TM.src_embeds()
    b, s = toks.shape
    cfg = _jax_cfg(TM.ENCDEC)
    cache = jax.jit(functools.partial(jax_E.prepare_cross_cache, cfg))(
        params, jnp.asarray(embeds),
        jax_E.init_cache(cfg, b, 16, TM.SRC_LEN))
    step = jax.jit(functools.partial(jax_E.decode_step, cfg))
    out = []
    for t in range(s):
        lg, cache = step(params, jnp.asarray(toks[:, t:t + 1]), cache,
                         jnp.full((b,), t + 1, jnp.int32))
        out.append(np.asarray(lg))
    return np.stack(out)


def _ref_tokens(params):
    with JaxServeEngine(JaxModel(_jax_cfg(JAMBA, "pooled", TM.SERVE_POOL)),
                        params, JaxEngineConfig(
                            slots=TM.SERVE_SLOTS,
                            max_len=TM.SERVE_MAX_LEN)) as eng:
        sched = JaxScheduler(eng)
        sched.submit([JaxRequest(uid=i, prompt=p,
                                 max_new_tokens=TM.SERVE_NEW)
                      for i, p in enumerate(TM.prompts())])
        done = sched.run()
    return {r.uid: tuple(r.output) for r in done}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The 4-rank spawn, and meanwhile the reference's and the one-device
    port's results on the same params."""
    archs = TM.DECODERS + (TM.ENCDEC,)
    params = {a: _numpy_params(TM.cfg_for(a), i) for i, a in enumerate(archs)}
    workdir = tmp_path_factory.mktemp("mixers")
    handle = TM.spawn(workdir, params)
    deadline = time.monotonic() + R.SPAWN_TIMEOUT
    try:
        jparams = {a: jax.tree.map(jnp.asarray, p) for a, p in params.items()}
        ref = {a: _ref_decoder(a, jparams[a]) for a in TM.DECODERS}
        ref[TM.ENCDEC] = _ref_encdec(jparams[TM.ENCDEC])
        ref["tokens"] = _ref_tokens(jparams[JAMBA])
        one = {}
        for a in TM.DECODERS:
            m = from_jax_params(TM.cfg_for(a), params[a], device="cpu")
            toks = TM.toks_for(a)
            one[a] = {"decode": {layout: R.decode_logits(
                m.with_config(TM.cfg_for(a, layout)), toks)
                for layout in set(TM.LAYOUTS[a].values())},
                "prefill": TM.prefill_run(m, toks)}
        m = from_jax_params(TM.cfg_for(TM.ENCDEC), params[TM.ENCDEC],
                            device="cpu")
        one[TM.ENCDEC] = TM.encdec_run(m, TM.src_embeds(),
                                       TM.toks_for(TM.ENCDEC))
        one["shapes"] = TM.shapes(m)
    finally:
        R.wait(handle, deadline)
    return {"ranks": R.load(workdir, "mixers", 4), "ref": ref, "one": one,
            "params": params}


def _same_on_every_rank(outs, get):
    first = get(outs[0])
    for o in outs[1:]:
        for a, b in zip(np.atleast_1d(get(o)), np.atleast_1d(first)):
            np.testing.assert_array_equal(a, b)
    return first


def _close(got, want, rtol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rtol * max(1.0, np.abs(want).max()), (what, err)


def _held(got, port, ref, vocab, what):
    _close(got, port, PORT_RTOL, what)
    _close(got[..., :vocab], ref[..., :vocab], REF_RTOL, what)


@pytest.mark.parametrize("arch", TM.DECODERS)
def test_split_ssm_decode_logits(run, arch):
    """Decode from scratch in the split form (jamba on the pooled layout
    at (1, 4), where its rank's one query head lies inside a KV-head
    group, and on the batch layout at (2, 2)): the same logits on every
    rank, the one-device port's within 1e-4, the reference's batch-layout
    decode within 1e-3."""
    vocab = TM.cfg_for(arch).vocab_size
    for shape in TM.MESHES:
        outs = [o[shape][arch] for o in run["ranks"]]
        got = _same_on_every_rank(outs, lambda o: o["decode"])
        layout = TM.LAYOUTS[arch][shape]
        _held(got, run["one"][arch]["decode"][layout],
              run["ref"][arch]["decode"], vocab, f"{arch} {shape} {layout}")


def _rank_channels(cfg, tp, index):
    """(the rank's x channels of the conv's [x | B | C], every B and C
    channel, the rank's heads) at tp ``tp``: written out here, apart from
    the port's cut, for G = 1."""
    hl, pd = cfg.ssm_heads // tp, cfg.ssm_head_dim
    di, gn = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state
    assert cfg.ssm_groups == 1
    return (np.arange(index * hl * pd, (index + 1) * hl * pd),
            np.arange(di, di + 2 * gn),
            np.arange(index * hl, (index + 1) * hl))


@pytest.mark.parametrize("arch", TM.DECODERS)
def test_split_ssm_prefill(run, arch):
    """Prefill of all but the last token (K5's plain path on the rank's
    heads, the gated norm over its channels with the tp sum of squares)
    into the rank's batch cache, then a decode step over it: logits held
    as decode's; every Mamba2 block's conv state is the one-device port's
    on the rank's x channels and every B/C channel, its SSD state the
    one-device port's on the rank's heads."""
    cfg = TM.cfg_for(arch)
    one_first, one_last, one_states = run["one"][arch]["prefill"]
    ref_first, ref_last = run["ref"][arch]["prefill"]
    for shape in TM.MESHES:
        outs = [o[shape][arch] for o in run["ranks"]]
        first = _same_on_every_rank(outs, lambda o: o["prefill"][0])
        last = _same_on_every_rank(outs, lambda o: o["prefill"][1])
        _held(first, one_first, ref_first, cfg.vocab_size, f"{shape} prefill")
        _held(last, one_last, ref_last, cfg.vocab_size,
              f"{shape} decode after prefill")
        for o in outs:
            tp, index = o["shard"]
            x, bc, heads = _rank_channels(cfg, tp, index)
            for block, st in o["prefill"][2].items():
                if "ssd" not in st:
                    continue
                want = one_states[block]
                _close(st["conv"], want["conv"][..., np.r_[x, bc]],
                       PORT_RTOL, f"{shape} {block} conv")
                _close(st["ssd"], want["ssd"][:, :, heads], PORT_RTOL,
                       f"{shape} {block} ssd")


def test_split_encdec(run):
    """seamless-m4t-medium in the split form (a rank's encoder, self- and
    cross-attention heads, MLP columns and vocab block):
    ``prepare_cross_cache`` then 8 decode steps, the same logits on every
    rank, the one-device port's within 1e-4 and the reference's within
    1e-3; its self- and cross-attention caches hold the rank's KV heads;
    every weight the rank holds is 1/tp of the whole along its split dim,
    the norms whole."""
    cfg = TM.cfg_for(TM.ENCDEC)
    want, want_cache = run["one"][TM.ENCDEC]
    for shape in TM.MESHES:
        tp = shape[1]
        outs = [o[shape][TM.ENCDEC] for o in run["ranks"]]
        got = _same_on_every_rank(outs, lambda o: o["decode"])
        _held(got, want, run["ref"][TM.ENCDEC], cfg.vocab_size,
              f"seamless {shape}")
        for o in outs:
            for name, whole in want_cache.items():
                local = list(whole)
                local[2] //= tp
                assert o["cache"][name] == tuple(local), (name, shape)
            for path, whole in run["one"]["shapes"].items():
                leaf = path.split("/")[-1]
                dim = (None if leaf == "w" else 0 if leaf == "tok"
                       else len(whole) - (2 if leaf == "wo" or leaf == "w_down"
                                          else 1))
                local = tuple(n // tp if i == dim else n
                              for i, n in enumerate(whole))
                assert o["shapes"][path] == local, (path, shape)


def test_split_jamba_serving_tokens(run):
    """A seeded 2-request swap trace of jamba on the pooled layout (4
    frames of 4 slots over 2 kv ranks, 2 slots) served by the split form:
    the reference engine's tokens per uid on every rank, a sequence
    swapped out and back in with its rank's conv/SSD rows, no frame
    leaked."""
    for o in run["ranks"]:
        tokens, stats = o[TM.SERVE_MESH][JAMBA]["serve"]
        assert tokens == run["ref"]["tokens"]
        assert stats["swapped"] > 0 and stats["swap_resumed"] > 0
        assert stats["leaked_frames"] == 0


def test_each_rank_holds_its_ssm_shards(run):
    """A rank's first Mamba2 block holds, of the whole weights, the z, x
    and dt columns of its heads and every B/C column of ``w_in``, its x
    channels and every B/C channel of ``conv_w`` / ``conv_b``, its
    channels of ``norm_w`` and rows of ``w_out``, its heads of ``a_log``,
    ``dt_bias`` and ``d_skip``; the shard records (tp, index); every
    registered arch's smoke config splits."""
    for arch in TM.DECODERS:
        cfg = TM.cfg_for(arch)
        whole = run["params"][arch][TM.MAMBA_BLOCK[arch]]["mamba"]
        di, gn = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state
        for shape in TM.MESHES:
            for rank, o in enumerate(run["ranks"]):
                res = o[shape][arch]
                tp, index = res["shard"]
                assert (tp, index) == (shape[1], rank % shape[1])
                x, bc, heads = _rank_channels(cfg, tp, index)
                conv = np.r_[x, bc]
                want = {"w_in": whole["w_in"][..., np.r_[
                            x, di + conv, 2 * di + 2 * gn + heads]],
                        "conv_w": whole["conv_w"][..., conv],
                        "conv_b": whole["conv_b"][..., conv],
                        "norm_w": whole["norm_w"][..., x],
                        "w_out": whole["w_out"][..., x, :]}
                for name in ("a_log", "dt_bias", "d_skip"):
                    want[name] = whole[name][..., heads]
                assert set(want) == set(res["mamba"])
                for name, w in want.items():
                    np.testing.assert_array_equal(res["mamba"][name], w,
                                                  err_msg=f"{arch} {name}")
    for shape in TM.MESHES:
        for rank, o in enumerate(run["ranks"]):
            assert o[shape]["every_arch"] == {
                a: (shape[1], rank % shape[1]) for a in list_archs()}


def _per_step(cfg):
    """All-reduces a batch-layout decode step of ``cfg`` calls: two a
    Mamba2 layer (the gated norm's sum of squares, ``w_out``), one an
    attention layer (``wo``), one a layer with an MLP or MoE (``w_down``,
    the combine), one for the embedding."""
    kinds = [cfg.layer_kind(i % cfg.layer_period)
             for i in range(cfg.n_layers)]
    ffn = sum(cfg.layer_has_mlp(i % cfg.layer_period)
              for i in range(cfg.n_layers))
    return (2 * kinds.count("mamba") + kinds.count("attn") + ffn + 1,
            kinds.count("attn"))


def test_collectives_per_step(run):
    """Calls a decode step makes over the groups: on the batch layout the
    all-reduces of ``_per_step`` and the logits' all_gather; on the pooled
    layout each attention layer also gathers the rank's k/v heads and the
    kv merge calls two; the prefill and its decode step twice a batch
    step's; seamless's decode 3 a decoder layer plus 1, and its encoder 2
    a layer once."""
    for shape in TM.MESHES:
        for o in run["ranks"]:
            for arch in TM.DECODERS:
                cfg, res = TM.cfg_for(arch), o[shape][arch]
                steps = TM.STEPS[arch]
                reduce, attn = _per_step(cfg)
                gather = 1
                if TM.LAYOUTS[arch][shape] == "pooled":
                    reduce, gather = reduce + 2 * attn, gather + attn
                assert res["calls"] == {
                    "all_to_all": 0, "all_reduce": reduce * steps,
                    "all_gather": gather * steps}, (arch, shape)
                reduce, _ = _per_step(cfg)
                assert res["prefill_calls"] == {
                    "all_to_all": 0, "all_reduce": 2 * reduce,
                    "all_gather": 2}, (arch, shape)
            cfg = TM.cfg_for(TM.ENCDEC)
            steps = TM.STEPS[TM.ENCDEC]
            assert o[shape][TM.ENCDEC]["calls"] == {
                "all_to_all": 0,
                "all_reduce": 2 * cfg.n_encoder_layers
                + steps * (3 * cfg.n_layers + 1),
                "all_gather": steps}, shape
