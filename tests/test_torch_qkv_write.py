"""The decode path's q/k epilogue and K/V write (K1 ``paged_qkv_write``'s
plain version) against the JAX reference.

The same numpy inputs (qwen3-0.6b's smoke widths with ``qk_norm``, and a
``qkv_bias`` variant; random norm weights and biases) go through the
reference's ``layers._project_qkv`` followed by its ``paged_kv_write``
kernel in interpret mode, and through the port's
``ref.qkv_write`` on the same raw projections (computed once, by JAX, so
that only the epilogue and the write differ).  The rows cover every drop:
write mask off, length 0, an unmapped page, a read-only frame, and at two
emulated shards the other shard's frames.  Tolerances: q and the written K
rows within rtol/atol 1e-5 in f32 (the same arithmetic, a sum of squares in
another order), within one bf16 rounding step (2^-7 |x|) in bf16; V rows
and every untouched slot bit for bit.  A few pooled decode steps of the
port at the ``qkv_bias`` variant match the reference's logits and pages,
and the kernel wrappers refuse CPU tensors.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_smoke_config  # noqa: E402
from repro.kernels.paged_decode.kernel import paged_kv_write  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import layers as jax_L  # noqa: E402
from repro.models import transformer as jax_T  # noqa: E402
from repro_torch.kernels.paged_decode import kernel as pt_kernel  # noqa: E402
from repro_torch.kernels.paged_decode import ref as pt_ref  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

torch.set_num_threads(2)

# one compile per page shape and dtype, shared by the cases
_jax_write = jax.jit(functools.partial(paged_kv_write, interpret=True))

SLOTS, MAX_LP = 4, 4
# row: 0 writes (frame even), 1 write mask off, 2 length 0 (no pages),
# 3 its page unmapped, 4 its page the shared read-only frame, 5 writes
# (frame odd): at two shards each shard owns one of the two writes
LENGTHS = np.array([7, 5, 0, 10, 3, 13], np.int32)
WRITE_MASK = np.array([True, False, True, True, True, True])
B = len(LENGTHS)
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2.0 ** -7, atol=0.0)}


def _cfg(variant):
    cfg = get_smoke_config("qwen3-0.6b")
    return dataclasses.replace(cfg, qkv_bias=True) if variant == "bias" else cfg


def _tables(rng):
    """Block tables over B * MAX_LP frames (block_table, frame_lpage,
    frame_ro): page 0 of rows 3 and 4 is one read-only frame, row 3's page
    2 is unmapped, row 0's written frame is even and row 5's odd."""
    n_frames = B * MAX_LP
    bt = np.full((B, MAX_LP), -1, np.int32)
    fl = np.zeros((n_frames,), np.int32)
    fr = np.zeros((n_frames,), bool)
    free = [int(f) for f in rng.permutation(n_frames)]
    shared = free.pop()
    fr[shared] = True

    def take(parity=None):
        f = next(f for f in free if parity is None or f % 2 == parity)
        free.remove(f)
        return f
    for s in range(B):
        for lp in range(-(-int(LENGTHS[s]) // SLOTS)):
            if s in (3, 4) and lp == 0:
                bt[s, lp] = shared
            elif not (s == 3 and lp == 2):
                last = lp == (LENGTHS[s] - 1) // SLOTS
                bt[s, lp] = take({0: 0, 5: 1}.get(s) if last else None)
                fl[bt[s, lp]] = lp
    return bt, fl, fr


def _inputs(seed, cfg, dtype):
    """Weights, x and pages as numpy arrays of ``dtype`` (bf16 through
    ml_dtypes, rounded to nearest as torch rounds), and the tables."""
    rng = np.random.default_rng(seed)
    d, hd = cfg.d_model, cfg.hd
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    w = {"wq": (d, nq), "wk": (d, nkv), "wv": (d, nkv), "bq": (nq,),
         "bk": (nkv,), "bv": (nkv,), "q_norm": (hd,), "k_norm": (hd,)}
    nt = jnp.dtype(dtype)
    p = {k: (rng.normal(size=s) * (d ** -0.5 if k[0] == "w" else 1.0)
             ).astype(np.float32).astype(nt)
         for k, s in w.items() if cfg.qkv_bias or k[0] != "b"}
    x = rng.normal(size=(B, 1, d)).astype(np.float32).astype(nt)
    pages = rng.normal(size=(2, B * MAX_LP, SLOTS, cfg.n_kv_heads, hd))
    bt, _, fr = _tables(rng)
    return p, x, pages.astype(np.float32).astype(nt), bt, fr


def _np32(a):
    return np.asarray(a).astype(np.float32)


def _torch(a, dtype):
    return torch.tensor(_np32(a)).to(getattr(torch, dtype))


def _close(got, want, dtype, what):
    np.testing.assert_allclose(got, want, **TOL[dtype], err_msg=what)


def _jax_qkv(cfg, p, x, positions):
    """The raw projections [B, 1, H * hd] and ``_project_qkv``'s output, in
    one program (so that both hold the same products)."""
    raw = [x @ p["w" + n] for n in "qkv"]
    if cfg.qkv_bias:
        raw = [a + p["b" + n] for a, n in zip(raw, "qkv")]
    return raw, jax_L._project_qkv(cfg, p, x, positions)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["qk_norm", "bias"])
def test_qkv_write_matches_jax(variant, dtype):
    """Port ``ref.qkv_write`` == the reference's ``_project_qkv`` epilogue +
    ``paged_kv_write`` (interpret) on every emulated shard of 1 and 2."""
    cfg = _cfg(variant)
    p, x, pages, bt, fr = _inputs(11, cfg, dtype)
    b, h, hkv, hd = B, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    jp, x = {n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x)
    raw, (q, k, v) = jax.jit(functools.partial(_jax_qkv, cfg))(
        jp, x, jnp.asarray(LENGTHS - 1)[:, None])
    tp = {name: _torch(a, dtype) for name, a in p.items()}
    pcfg = ModelConfig(**dataclasses.asdict(cfg))
    tq, tk, tv = (_torch(a, dtype).view(b, n, hd)
                  for a, n in zip(raw, (h, hkv, hkv)))
    kp_all, vp_all = pages
    for n_shards in (1, 2):
        written = 0
        for sid in range(n_shards):
            kp, vp = kp_all[sid::n_shards], vp_all[sid::n_shards]
            jk, jv = _jax_write(
                k[:, :, 0], v[:, :, 0], jnp.asarray(kp), jnp.asarray(vp),
                jnp.asarray(bt),
                jnp.asarray(LENGTHS), jnp.asarray(fr), jnp.asarray(WRITE_MASK),
                jnp.asarray([sid, n_shards, 0], jnp.int32))
            pk, pv = _torch(kp, dtype), _torch(vp, dtype)
            pq = pt_ref.qkv_write(
                tq, tk, tv, pk, pv, torch.tensor(LENGTHS), torch.tensor(bt),
                torch.tensor(fr), torch.tensor(WRITE_MASK), sid=sid,
                n_shards=n_shards, max_pages=MAX_LP,
                **L.qk_epilogue_args(pcfg, tp))
            what = f"{variant} {dtype} shard {sid} of {n_shards}"
            _close(pq.float().numpy(), _np32(q[:, :, 0]), dtype, "q " + what)
            np.testing.assert_array_equal(pv.float().numpy(), _np32(jv),
                                          err_msg="v pages " + what)
            hit = (_np32(jv) != _np32(vp)).any(axis=(2, 3))   # written slots
            written += int(hit.sum())
            pk, jk = pk.float().numpy(), _np32(jk)
            np.testing.assert_array_equal(pk[~hit], jk[~hit],
                                          err_msg="untouched k " + what)
            _close(pk[hit], jk[hit], dtype, "written k " + what)
        assert written == 2, f"{written} writes at {n_shards} shards"


def _randomize(tree, rng):
    """Random biases and norm weights in place of the reference's zeros and
    ones."""
    for key, val in tree.items():
        if isinstance(val, dict):
            _randomize(val, rng)
        elif key in ("bq", "bk", "bv", "q_norm", "k_norm"):
            tree[key] = rng.normal(size=val.shape).astype(val.dtype)


def test_pooled_decode_steps_match_jax():
    """Three pooled decode steps of the ``qkv_bias`` variant (random biases
    and norm weights) through both frameworks on the same weights, pages,
    tables and tokens: logits and pages within atol 1e-4 (f32), the
    read-only frame untouched."""
    cfg = dataclasses.replace(_cfg("bias"), kv_layout="pooled",
                              kv_page_slots=SLOTS)
    rng = np.random.default_rng(3)
    params = jax.tree.map(np.asarray,
                          jax.jit(JaxModel(cfg).init)(jax.random.key(0)))
    _randomize(params, rng)
    shape = JaxModel(cfg).init_cache(B, SLOTS * MAX_LP)["b0"]["k_pages"].shape
    kp, vp = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    bt, fl, fr = _tables(rng)
    vm = {"block_table": bt, "frame_lpage": fl, "frame_ro": fr}
    jcache = {"b0": {"k_pages": jnp.asarray(kp), "v_pages": jnp.asarray(vp)},
              "vm": {k: jnp.asarray(a) for k, a in vm.items()}}
    model = from_jax_params(ModelConfig(**dataclasses.asdict(cfg)), params,
                            device="cpu")
    pcache = model.init_cache(B, SLOTS * MAX_LP)
    pcache["b0"]["k_pages"].copy_(torch.tensor(kp))
    pcache["b0"]["v_pages"].copy_(torch.tensor(vp))
    pcache["vm"] = {k: torch.tensor(a) for k, a in vm.items()}
    jparams = jax.tree.map(jnp.asarray, params)
    jax_step = jax.jit(functools.partial(jax_T.decode_step, cfg))
    lengths = np.array([6, 5, 1, 9, 2, 11], np.int32)
    for _ in range(3):
        toks = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        jl, jcache = jax_step(jparams, jnp.asarray(toks), jcache,
                              jnp.asarray(lengths), jnp.asarray(WRITE_MASK))
        pl, pcache = model.decode_step(torch.tensor(toks), pcache,
                                       torch.tensor(lengths),
                                       torch.tensor(WRITE_MASK))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
        lengths = lengths + 1
    for name in ("k_pages", "v_pages"):
        np.testing.assert_allclose(pcache["b0"][name].numpy(),
                                   np.asarray(jcache["b0"][name]), atol=1e-4,
                                   rtol=0)
    sh = int(np.flatnonzero(fr)[0])
    np.testing.assert_array_equal(pcache["b0"]["k_pages"][:, sh].numpy(),
                                  kp[:, sh])


def test_qkv_wrappers_raise_on_cpu_tensors():
    """The fused K1 entries refuse CPU tensors (no interpret mode) and count
    no launch; ``paged_kernel="composed"``/``"auto"`` is the CPU path."""
    cfg = _cfg("qk_norm")
    _, _, pages, bt, fr = _inputs(5, cfg, "float32")
    hd = cfg.hd
    q = torch.zeros((B, cfg.n_heads, hd))
    k = torch.zeros((B, cfg.n_kv_heads, hd))
    kp = torch.tensor(pages[0])
    args = dict(q_norm=torch.ones(hd), k_norm=torch.ones(hd), eps=1e-6,
                rope_theta=1e4)
    pt_kernel.reset_launch_counts()
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        pt_kernel.paged_qkv_write(q, k, k.clone(), kp, kp.clone(),
                                  torch.tensor(bt), torch.tensor(LENGTHS),
                                  torch.tensor(fr), torch.tensor(WRITE_MASK),
                                  (0, 1, 0), **args)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        pt_kernel.qk_rotate(q, k, torch.tensor(LENGTHS), **args)
    np.testing.assert_array_equal(kp.numpy(), pages[0])
    assert pt_kernel.LAUNCHES == {"paged_kv_write": 0,
                                  "paged_gather_attend": 0}
