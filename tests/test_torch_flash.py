"""The port's plain flash-attention (K3) and flash-decode (K4) versions
against the JAX reference.

The same numpy inputs go through the port's ``ref.mha`` and
``layers.chunked_attention`` and through JAX's Pallas ``flash_attention``
(interpret mode, 8 x 8 blocks) and JAX's ``chunked_attention``, over
causal, windowed, GQA and tail-query cases (tests/test_kernels.py:58,70);
and through the port's plain ``decode_attention_partial`` and
``merge_partials`` and JAX's Pallas ``flash_decode`` (interpret mode),
including a length-0 row (tests/test_kernels.py:85,99); and the
arithmetic of K4's split walk: the plain partials over its 64-position
splits, merged in split order, equal the unsplit plain version and JAX's
``flash_decode``.  Tolerance: rtol 1e-5, atol 1e-5 in f32 -- the same
function, the softmax summed in another order.  These plain versions are
what chip_smoke.py holds the CUDA kernels against on the card; here the
kernel wrappers refuse CPU tensors.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels.flash_attention import kernel as jax_fa  # noqa: E402
from repro.kernels.paged_decode import flash as jax_fd  # noqa: E402
from repro.kernels.paged_decode import flash_ops as jax_fd_ops  # noqa: E402
from repro.kernels.paged_decode import flash_ref as jax_fd_ref  # noqa: E402
from repro.models.layers import chunked_attention as jax_chunked  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as pt_fa  # noqa: E402
from repro_torch.kernels.flash_attention import ops as pt_fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as pt_fa_ref  # noqa: E402
from repro_torch.kernels.paged_decode import flash as pt_fd  # noqa: E402
from repro_torch.kernels.paged_decode import flash_ops as pt_fd_ops  # noqa: E402
from repro_torch.kernels.paged_decode import flash_ref as pt_fd_ref  # noqa: E402
from repro_torch.models.layers import chunked_attention  # noqa: E402

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)

#: (hq, hkv, sq, skv, causal, window, kv_valid_len)
FA_CASES = {
    "causal-gqa": (4, 2, 32, 32, True, None, None),
    "causal-window-mqa": (8, 1, 32, 32, True, 16, None),
    "window-noncausal": (4, 4, 32, 32, False, 8, (32, 19)),
    "tail-queries": (2, 2, 8, 32, True, None, None),
}


@pytest.mark.parametrize("case", list(FA_CASES))
def test_flash_attention_plain_versions_match_jax(case):
    """ref.mha (K3's plain version) and chunked_attention against the JAX
    Pallas kernel and JAX chunked_attention (kv_valid_len in one case)."""
    hq, hkv, sq, skv, causal, window, valid = FA_CASES[case]
    rng = np.random.default_rng(len(case))
    q = rng.normal(size=(2, hq, sq, 16)).astype(np.float32)
    k = rng.normal(size=(2, hkv, skv, 16)).astype(np.float32)
    v = rng.normal(size=(2, hkv, skv, 16)).astype(np.float32)
    kw = dict(causal=causal, window=window)
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    chunk = dict(chunk_q=8, chunk_k=8)
    if valid is None:
        want = np.asarray(jax_fa.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=8,
            block_k=8, interpret=True, **kw))
        np.testing.assert_allclose(pt_fa_ref.mha(tq, tk, tv, **kw).numpy(),
                                   want, **TOL)
        # on CPU tensors the dispatch is the plain oracle
        np.testing.assert_array_equal(
            pt_fa_ops.flash_attention(tq, tk, tv, **kw).numpy(),
            pt_fa_ref.mha(tq, tk, tv, **kw).numpy())
    valid_j = None if valid is None else jnp.asarray(valid, jnp.int32)
    valid_t = None if valid is None else torch.tensor(valid, dtype=torch.int32)
    want = np.asarray(jax_chunked(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), kv_valid_len=valid_j,
                                  **kw, **chunk))
    got = chunked_attention(tq, tk, tv, kv_valid_len=valid_t, **kw, **chunk)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _decode_inputs(seed, lengths, s=32):
    rng = np.random.default_rng(seed)
    b, hkv, g, d = len(lengths), 2, 4, 16
    return (rng.normal(size=(b, hkv * g, d)).astype(np.float32),
            rng.normal(size=(b, hkv, s, d)).astype(np.float32),
            rng.normal(size=(b, hkv, s, d)).astype(np.float32),
            np.asarray(lengths, np.int32))


@pytest.mark.parametrize("window", [None, 8])
def test_decode_partial_matches_jax_kernel(window):
    """K4's plain version (the non-kernel branch of
    decode_attention_partial) against the JAX Pallas flash_decode: out, m
    and l, a length-0 row included ((0, -1e30, 0) on both); decode_attention
    against JAX flash_ref on every row."""
    q, k, v, lengths = _decode_inputs(3, [32, 9, 0, 17, 1])
    b, hq, d = q.shape
    hkv = k.shape[1]
    out, m, l = jax_fd.flash_decode(
        jnp.asarray(q.reshape(b, hkv, hq // hkv, d)), jnp.asarray(k),
        jnp.asarray(v), jnp.asarray(lengths), window=window, block_k=8,
        interpret=True)
    t = [torch.tensor(a) for a in (q, k, v, lengths)]
    po, pm, pl = pt_fd_ops.decode_attention_partial(*t, window=window)
    np.testing.assert_allclose(po.numpy(), np.asarray(out).reshape(b, hq, d),
                               **TOL)
    np.testing.assert_allclose(pm.numpy(), np.asarray(m).reshape(b, hq), **TOL)
    np.testing.assert_allclose(pl.numpy(), np.asarray(l).reshape(b, hq), **TOL)
    assert (po[2] == 0).all() and (pm[2] == -1e30).all() and (pl[2] == 0).all()
    want = jax_fd_ref.decode_attention(*(jnp.asarray(a) for a in (q, k, v,
                                                                  lengths)),
                                       window=window)
    for got in (pt_fd_ref.decode_attention(*t, window=window),
                pt_fd_ops.decode_attention(*t, window=window)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_merge_partials_matches_jax():
    """Partials over 4 KV shards merge to full attention, as in the
    reference (tests/test_kernels.py:99); both merges agree with JAX's."""
    q, k, v, lengths = _decode_inputs(5, [32, 20, 0])
    sp, n_parts = 8, 4
    parts_pt, parts_jax = [], []
    for p in range(n_parts):
        lp = np.clip(lengths - p * sp, 0, sp).astype(np.int32)
        sl = slice(p * sp, (p + 1) * sp)
        parts_pt.append(pt_fd_ops.decode_attention_partial(
            torch.tensor(q), torch.tensor(k[:, :, sl]),
            torch.tensor(v[:, :, sl]), torch.tensor(lp)))
        parts_jax.append(jax_fd_ops.decode_attention_partial(
            jnp.asarray(q), jnp.asarray(k[:, :, sl]), jnp.asarray(v[:, :, sl]),
            jnp.asarray(lp), use_pallas=False))
    merged = pt_fd_ops.merge_partials(*(torch.stack([p[i] for p in parts_pt])
                                        for i in range(3)))
    want = jax_fd_ops.merge_partials(*(jnp.stack([p[i] for p in parts_jax])
                                       for i in range(3)))
    np.testing.assert_allclose(merged.numpy(), np.asarray(want), **TOL)
    full = pt_fd_ref.decode_attention(*(torch.tensor(a) for a in (q, k, v,
                                                                   lengths)))
    np.testing.assert_allclose(merged[:2].numpy(), full[:2].numpy(), **TOL)
    assert (merged[2] == 0).all()          # nothing attended anywhere
    # the ref module's list-of-partials merge, on the unnormalised partials
    pos = torch.arange(k.shape[2])[None, :]
    raw = [pt_fd_ref.decode_attention_partial(
        torch.tensor(q), torch.tensor(k[:, :, p * sp:(p + 1) * sp]),
        torch.tensor(v[:, :, p * sp:(p + 1) * sp]),
        (pos[:, p * sp:(p + 1) * sp] < torch.tensor(lengths)[:, None]))
        for p in range(n_parts)]
    np.testing.assert_allclose(pt_fd_ref.merge_partials(raw).numpy(),
                               merged.numpy(), **TOL)


def test_decode_splits_merge_to_unsplit():
    """K4's arithmetic: the plain branch of decode_attention_partial run on
    each of the kernel's 64-position splits of S = 200 (the last one 8
    long), with lengths shifted to the split (so the window's lower edge
    stays where it was), merged in split order by merge_splits, equals the
    unsplit plain version and JAX's flash_decode (interpret mode): out, m
    and l.  Lengths put row ends at split edges (63, 64, 65), leave splits
    empty, and one row is empty ((0, -1e30, 0)); window 40 straddles the
    edges at 64 and 128."""
    lengths = [200, 0, 63, 64, 65, 129]
    q, k, v, lengths = _decode_inputs(11, lengths, s=200)
    b, hq, d = q.shape
    hkv = k.shape[1]
    sp = pt_fd.SPLIT
    n = pt_fd.n_splits(k.shape[2])
    assert (sp, n) == (64, 4)
    t = [torch.tensor(a) for a in (q, k, v, lengths)]
    for window in (None, 40):
        cut = [slice(j * sp, (j + 1) * sp) for j in range(n)]
        parts = [pt_fd_ops.decode_attention_partial(
            t[0], t[1][:, :, c], t[2][:, :, c], t[3] - j * sp, window=window)
            for j, c in enumerate(cut)]
        out, m, l = pt_fd_ops.merge_splits(
            *(torch.stack([p[i] for p in parts]) for i in range(3)))
        whole = pt_fd_ops.decode_attention_partial(*t, window=window)
        jo, jm, jl = jax_fd.flash_decode(
            jnp.asarray(q.reshape(b, hkv, hq // hkv, d)), jnp.asarray(k),
            jnp.asarray(v), jnp.asarray(lengths), window=window,
            interpret=True)
        for got, plain, want in ((out, whole[0], jo), (m, whole[1], jm),
                                 (l, whole[2], jl)):
            np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
            np.testing.assert_allclose(got.numpy(),
                                       np.asarray(want).reshape(got.shape),
                                       **TOL)
        assert (out[1] == 0).all() and (m[1] == -1e30).all() \
            and (l[1] == 0).all()
        # a row that ends inside split 0 leaves splits 1-3 empty
        assert all((p[2][2] == 0).all() for p in parts[1:])


def test_flash_attention_variant_choice():
    """K3's wrapper picks the tensor-core variant for bf16 at head dims 64
    and 128 with aligned K/V, the CUDA-core variant for everything else."""
    assert pt_fa.variant_for(torch.bfloat16, 128) == "tensor_core"
    assert pt_fa.variant_for(torch.bfloat16, 64) == "tensor_core"
    for dtype, d, aligned in ((torch.bfloat16, 96, True),
                              (torch.bfloat16, 32, True),
                              (torch.bfloat16, 128, False),
                              (torch.float32, 128, True),
                              (torch.float32, 64, True)):
        assert pt_fa.variant_for(dtype, d, aligned) == "cuda_core"


def test_kernel_wrappers_raise_on_cpu_tensors():
    """A CUDA kernel has no interpret mode: K3's and K4's wrappers, and the
    dispatch asked for the kernel, refuse CPU tensors and count no
    launch."""
    q = torch.zeros((1, 2, 4, 16))
    k = torch.zeros((1, 2, 4, 16))
    lengths = torch.ones((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        pt_fa.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        pt_fa_ops.flash_attention(q, k, k, use_kernel=True)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        pt_fd.flash_decode(q[:, :, :1], k, k, lengths)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        pt_fd_ops.decode_attention(q[:, :, 0], k, k, lengths, use_kernel=True)
    assert pt_fa.LAUNCHES == {"flash_attention": 0, "flash_attention_tc": 0}
    assert pt_fd.LAUNCHES == {"flash_decode": 0}
