"""The port's fp8 KV cache (``kv_dtype="float8_e4m3fn"``) and its
data-parallel microbatches against the JAX reference on the CPU.

fp8 K/V rows are written with the reference's bits: ml_dtypes' cast,
round to nearest even with NaN past 464 (448 and half a step), which
torch's own cast does not give (it saturates at 448).  The port casts
through ``layers.cast_kv``, so its paged write (``ref.write_kv``, the plain
version of K1), its batch-layout write (through the cache's bytes, which
the CPU's gather and scatter take) and its prefill agree with the
reference byte for byte, NaN included.  Held here:

  * every bf16 value and f32 values at e4m3's edges cast byte for byte as
    ml_dtypes casts them; the paged decode shard on fp8 pages, new rows
    past the range included, against the reference's composed versions
    and its interpret-mode fused one (no window): pages byte for byte,
    (acc, m, l) within 1e-5 (the
    values widened to f32 exactly on both sides; NaN where the composed
    oracles have it: they leak a NaN V row into the other sequences' sums
    as 0 * NaN, where the fused kernel does not);
  * K4's plain version over fp8 batch caches against the reference's
    plain version and its interpret-mode kernel (no window);
  * a tiny dense decode step with fp8 KV, pooled and batch layouts:
    caches byte for byte, logits within LOGIT_ATOL;
  * the trainer's microbatch rows and per-microbatch loss weights at dp 2
    against the reference's ``_split_micro`` and ``Model.loss`` on a mask
    that is not uniform (the parent's rows and weight did not give it);
  * ``build.dtype_code`` takes float8_e4m3fn, and the kernel wrappers still
    refuse CPU tensors.
"""
import dataclasses
import functools

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch_decode_parity as P  # noqa: E402

from repro.kernels.paged_decode import flash_ops as jax_flash  # noqa: E402
from repro.kernels.paged_decode import ops as jax_ops  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import transformer as jax_T  # noqa: E402
from repro.train import trainer as jax_trainer  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.paged_decode import flash as pt_flash  # noqa: E402
from repro_torch.kernels.paged_decode import flash_ops as pt_flash_ops  # noqa: E402
from repro_torch.kernels.paged_decode import kernel as pt_kernel  # noqa: E402
from repro_torch.kernels.paged_decode import ops as pt_ops  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.train import trainer as pt_trainer  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

torch.set_num_threads(2)

FP8 = ml_dtypes.float8_e4m3fn
TOL = dict(rtol=1e-5, atol=1e-5)
#: decode logits: the caches are held byte for byte, so the logits differ
#: by f32 summation order only, as in torch_decode_parity (1e-4); one e4m3
#: step (2^-3 of a value) in a single K/V element would move them by far
#: more at these widths
LOGIT_ATOL = P.ATOL


def _pt(a: np.ndarray) -> torch.Tensor:
    """A numpy array as a torch tensor; fp8 through its bytes."""
    if a.dtype == FP8:
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.tensor(a)


def _bytes(t) -> np.ndarray:
    """An fp8 array's bytes, from torch or from JAX."""
    if isinstance(t, torch.Tensor):
        return t.view(torch.uint8).numpy()
    return np.asarray(t).view(np.uint8)


def _paged_case(seed, scale_row0=300.0):
    """Three sequences on scrambled tables over fp8 pages: row 0's new K/V
    scaled past e4m3's range, row 1 writing the shared read-only page 0,
    row 2 masked."""
    rng = np.random.default_rng(seed)
    b, max_lp, slots, hkv, group, hd = 3, 4, 8, 2, 2, 16
    lengths = np.array([25, 5, 17], np.int32)
    n_frames = b * max_lp
    bt = np.full((b, max_lp), -1, np.int32)
    fl = np.zeros(n_frames, np.int32)
    fr = np.zeros(n_frames, bool)
    free = list(rng.permutation(n_frames))
    sh = int(free.pop())
    fr[sh] = True
    for s in range(b):
        for lp in range(-(-int(lengths[s]) // slots)):
            f = sh if lp == 0 else int(free.pop())
            bt[s, lp], fl[f] = f, lp
    new = rng.normal(size=(2, b, hkv, hd)).astype(np.float32)
    new[:, 0] *= scale_row0
    pages = rng.normal(size=(2, n_frames, slots, hkv, hd)).astype(FP8)
    return dict(q=rng.normal(size=(b, hkv * group, hd)).astype(np.float32),
                k_new=new[0], v_new=new[1], kp=pages[0], vp=pages[1],
                lengths=lengths, bt=bt, fl=fl, fr=fr,
                wm=np.array([True, True, False])), \
        dict(group=group, max_pages=max_lp)


def test_fp8_writes_match_reference_bytes():
    """``cast_kv`` gives ml_dtypes' bytes for every bf16 value and f32 ones
    at e4m3's edges (torch's own cast does not past 464); the paged decode
    shard on fp8 pages (composed, the plain version of K1 + K2) against
    the reference's composed versions, windows None and 8, and its
    interpret-mode fused kernel, no window: pages byte for byte, NaN
    written for row 0 on both sides, (acc, m, l) within TOL (NaN
    where the composed oracle has it; against the fused kernel, which does
    not sum other sequences' NaN V rows as 0 * NaN, where the port is
    finite)."""
    bf16 = torch.arange(-32768, 32768, dtype=torch.int32).to(
        torch.int16).view(torch.bfloat16)
    # e4m3's largest value, the round-to-NaN threshold and past it, the
    # least normal and subnormal and half of it, signed zeros, inf, NaN
    edges = np.array([448.0, 463.9999, 464.0, 464.0001, 480.0, 2.0 ** -6,
                      2.0 ** -9, 2.0 ** -10, 1.5 * 2.0 ** -10, 0.0, np.inf,
                      np.nan], np.float32)
    f32 = np.concatenate([edges, -edges])
    with np.errstate(invalid="ignore"):
        for x in (bf16, torch.tensor(f32)):
            want = x.float().numpy().astype(FP8).view(np.uint8)
            np.testing.assert_array_equal(
                _bytes(L.cast_kv(x, torch.float8_e4m3fn)), want)
        assert (_bytes(torch.tensor(f32).to(torch.float8_e4m3fn))
                != f32.astype(FP8).view(np.uint8)).any()   # torch saturates

    x, kw = _paged_case(1234)
    for window in (None, 8):
        t = {k: _pt(v) for k, v in x.items()}
        port = [o for o in pt_ops.paged_decode_shard(
            t["q"], t["k_new"], t["v_new"], t["kp"], t["vp"], t["lengths"],
            t["bt"], t["fl"], t["fr"], t["wm"], sid=0, n_shards=1,
            head_start=0, group=kw["group"], window=window,
            max_pages=kw["max_pages"], use_vm=True, impl="composed")]
        assert (((_bytes(port[3]) & 0x7F) == 0x7F).sum() > 0)  # NaN written
        for impl in ("composed",) + (("fused",) if window is None else ()):
            ref = jax.jit(functools.partial(
                jax_ops.paged_decode_shard, sid=0, n_shards=1, head_start=0,
                group=kw["group"], window=window, max_pages=kw["max_pages"],
                use_vm=True, impl=impl, interpret=True))(
                *(jnp.asarray(x[k]) for k in ("q", "k_new", "v_new", "kp",
                                              "vp", "lengths", "bt", "fl",
                                              "fr", "wm")))
            for i in (3, 4):
                np.testing.assert_array_equal(_bytes(port[i]),
                                              _bytes(ref[i]), err_msg=impl)
            for i in range(3):
                got, want = port[i].numpy(), np.asarray(ref[i])
                if impl == "fused":
                    # the composed oracles' p.V sums every owned row,
                    # another sequence's NaN V row as 0 * NaN; the kernel
                    # reads a sequence's own pages only
                    assert np.isnan(got[np.isnan(want)]).all()
                    keep = ~np.isnan(got)
                    got, want = got[keep], want[keep]
                np.testing.assert_allclose(got, want, **TOL,
                                           err_msg=f"{impl} {window}")


def test_flash_decode_plain_fp8_matches_reference():
    """K4's plain version (``flash_ops`` without the kernel) over fp8 batch
    caches against the reference's plain branch and its Pallas kernel in
    interpret mode (no window), windows None and 5: out, m and l within
    TOL; row 1 is empty."""
    rng = np.random.default_rng(11)
    b, hkv, g, s, d = 3, 2, 2, 64, 16
    q = rng.normal(size=(b, hkv * g, d)).astype(np.float32)
    k, v = rng.normal(size=(2, b, hkv, s, d)).astype(FP8)
    lengths = np.array([37, 0, 64], np.int32)
    for window in (None, 5):
        _check_flash_decode(q, k, v, lengths, window)


def _check_flash_decode(q, k, v, lengths, window):
    port = pt_flash_ops.decode_attention_partial(
        _pt(q), _pt(k), _pt(v), _pt(lengths), window=window)
    for use_pallas in (False,) + ((True,) if window is None else ()):
        ref = jax_flash.decode_attention_partial(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(lengths), window=window, block_k=16,
            use_pallas=use_pallas, interpret=True)
        for got, want in zip(port, ref):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    whole = pt_flash_ops.decode_attention(_pt(q), _pt(k), _pt(v),
                                          _pt(lengths), window=window)
    want = jax_flash.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jnp.asarray(lengths),
                                      window=window, use_pallas=False)
    np.testing.assert_allclose(whole.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("layout", ["pooled", "batch"])
def test_decode_step_fp8_kv_matches_reference(layout):
    """qwen3-0.6b's smoke config with ``kv_dtype`` float8_e4m3fn, three
    decode steps with a masked slot on the ``layout`` cache (random fp8
    contents; pooled: scrambled tables, a shared read-only page 0): every
    cache byte equal to the reference's and the logits within
    LOGIT_ATOL."""
    from repro.configs import get_smoke_config
    cfg = dataclasses.replace(get_smoke_config("qwen3-0.6b"),
                              kv_dtype="float8_e4m3fn", kv_layout=layout,
                              kv_page_slots=P.SLOTS)
    rng = np.random.default_rng(5)
    params_np = P.seeded_params(cfg, rng)
    state = {key: {name: rng.normal(size=a.shape).astype(a.dtype)
                   for name, a in entry.items()}
             for key, entry in JaxModel(cfg).init_cache(P.B, P.MAX_LEN).items()
             if key != "vm"}
    jcache = {key: {n: jnp.asarray(a) for n, a in entry.items()}
              for key, entry in state.items()}
    model = from_jax_params(P.port_cfg(cfg), params_np, device="cpu")
    pcache = model.init_cache(P.B, P.MAX_LEN)
    for key, entry in state.items():
        for name, a in entry.items():
            assert pcache[key][name].dtype == torch.float8_e4m3fn
            pcache[key][name].copy_(_pt(a))
    if layout == "pooled":
        vm = P.tables(rng, -(-P.MAX_LEN // P.SLOTS))
        jcache["vm"] = {k: jnp.asarray(v) for k, v in vm.items()}
        pcache["vm"] = {k: torch.tensor(v) for k, v in vm.items()}
    params = jax.tree.map(jnp.asarray, params_np)
    lengths = np.array([3, 9, 14], np.int32)
    wm = np.array([True, True, False])
    jax_step = jax.jit(functools.partial(jax_T.decode_step, cfg))
    for _ in range(3):
        toks = rng.integers(0, cfg.vocab_size, (P.B, 1)).astype(np.int32)
        jl, jcache = jax_step(params, jnp.asarray(toks), jcache,
                              jnp.asarray(lengths), jnp.asarray(wm))
        pl, pcache = model.decode_step(torch.tensor(toks), pcache,
                                       torch.tensor(lengths),
                                       torch.tensor(wm))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL, rtol=0)
        lengths = lengths + 1
    for key, entry in state.items():
        for name in entry:
            np.testing.assert_array_equal(_bytes(pcache[key][name]),
                                          _bytes(jcache[key][name]),
                                          err_msg=f"{key}/{name}")


def test_microbatch_rows_and_weights_match_reference():
    """At 2 microbatches over 2 dp ranks: each rank's rows of microbatch i
    (``micro_rows``) joined in dp order are the reference's
    ``_split_micro`` microbatch i, and a rank's batch cuts back into them
    (``_split_micro``); the ranks' per-microbatch masked means weighted by
    ``micro_weights``, averaged over microbatches and dp, equal the
    reference's mean of its microbatches' ``Model.loss`` on a mask that is
    not uniform.  The parent's rows (the rank's contiguous block, then cut)
    and its whole-batch weight give another loss here."""
    from repro.configs import get_smoke_config
    cfg = get_smoke_config("qwen3-0.6b")
    rng = np.random.default_rng(3)
    params_np = P.seeded_params(cfg, rng)
    model = from_jax_params(P.port_cfg(cfg), params_np, device="cpu")
    b, s, n_micro, n_dp = 4, 8, 2, 2
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32), "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32), "mask": (rng.uniform(size=(b, s))
                            < np.array([0.9, 0.2, 0.6, 0.4])[:, None]
                            ).astype(np.float32)}
    micro = jax_trainer._split_micro(batch, n_micro)
    jloss = jax.jit(JaxModel(cfg).loss)
    params = jax.tree.map(jnp.asarray, params_np)
    want = np.mean([float(jloss(params, {k: v[i] for k, v in micro.items()}))
                    for i in range(n_micro)])

    def loss(rows):
        with torch.no_grad():
            return float(model.loss({k: torch.tensor(v[rows])
                                     for k, v in batch.items()}))

    def dp_loss(rows_of, weights_of):
        total = 0.0
        for r in range(n_dp):
            w = weights_of(r)
            total += np.mean([w[i] * loss(rows)
                              for i, rows in enumerate(rows_of(r))])
        return total / n_dp

    rows = [pt_trainer.micro_rows(b, n_micro, n_dp, r) for r in range(n_dp)]
    for i in range(n_micro):
        for k, v in batch.items():
            np.testing.assert_array_equal(
                np.concatenate([v[rows[r][i]] for r in range(n_dp)]),
                micro[k][i])
    for r in range(n_dp):
        local = {k: torch.tensor(np.concatenate([v[sl] for sl in rows[r]]))
                 for k, v in batch.items()}
        for i, mb in enumerate(pt_trainer._split_micro(local, n_micro)):
            for k, v in mb.items():
                np.testing.assert_array_equal(v.numpy(), batch[k][rows[r][i]])
    counts = torch.tensor([[batch["mask"][sl].sum() for sl in rows[r]]
                           for r in range(n_dp)])
    got = dp_loss(lambda r: rows[r], lambda r: pt_trainer.micro_weights(
        counts[r], counts.sum(0), n_dp).tolist())
    assert abs(got - want) < 1e-5, (got, want)
    # the parent: the rank's contiguous block, cut in turn; one weight
    m = b // n_dp

    def old_rows(r):
        return [slice(r * m + i * (m // n_micro), r * m + (i + 1) * (m // n_micro))
                for i in range(n_micro)]
    mask = batch["mask"]
    old = dp_loss(old_rows, lambda r: [mask[r * m:(r + 1) * m].sum() * n_dp
                                       / mask.sum()] * n_micro)
    assert abs(old - want) > 1e-3, (old, want)


def test_dtype_codes_and_fp8_wrappers_refuse_cpu():
    """``dtype_code`` takes float8_e4m3fn (code 2) and float8_e5m2 still
    raises NotImplementedError with its own message; ``compute_code``
    refuses fp8 as a compute dtype; K1, K2 and K4 refuse fp8 caches on
    the CPU as they refuse any CPU tensor, and count no launch."""
    fp8 = torch.zeros(4, dtype=torch.float8_e4m3fn)
    assert build.dtype_code(fp8, "k") == 2
    with pytest.raises(NotImplementedError, match="float8_e5m2"):
        build.dtype_code(fp8.to(torch.float8_e5m2), "k")
    with pytest.raises(TypeError, match="K/V cache dtype"):
        build.compute_code(fp8, "q")
    x, kw = _paged_case(99)
    t = {k: _pt(v) for k, v in x.items()}
    b, hl, hd = x["q"].shape
    qg = t["q"].reshape(b, hl // kw["group"], kw["group"], hd)
    before = dict(pt_kernel.LAUNCHES), dict(pt_flash.LAUNCHES)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        pt_kernel.paged_kv_write(t["k_new"], t["v_new"], t["kp"], t["vp"],
                                 t["bt"], t["lengths"], t["fr"], t["wm"],
                                 (0, 1, 0))
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        pt_kernel.paged_qkv_write(t["q"], t["k_new"], t["v_new"], t["kp"],
                                  t["vp"], t["bt"], t["lengths"], t["fr"],
                                  t["wm"], (0, 1, 0))
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        pt_kernel.paged_gather_attend(qg, t["kp"], t["vp"], t["bt"],
                                      t["lengths"], (0, 1, 0))
    k = t["kp"][:b].permute(0, 2, 1, 3).contiguous()
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        pt_flash.flash_decode(qg, k, k, t["lengths"])
    assert (dict(pt_kernel.LAUNCHES), dict(pt_flash.LAUNCHES)) == before
