"""The port's paged decode step against the JAX reference.

The same numpy inputs go through the port's composed oracle
(``repro_torch.kernels.paged_decode.ops``, ``impl="composed"``), the JAX
composed oracle and the JAX fused Pallas kernels in interpret mode; the
cases mirror tests/test_kernels.py's fused-vs-composed suite.  Pages must
be byte-equal (the write either lands the same row or drops it); ``m``,
``acc`` and ``l`` agree within rtol 1e-5, atol 1e-5 in f32 (the same
arithmetic summed in another order).  The composed oracle is also the plain
version the CUDA kernels are held against on the card (chip_smoke.py); here
the kernel wrappers refuse CPU tensors, and a 1-, 2- and 4-shard emulated
split, merged with the log-sum-exp formula, equals one shard.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.paged_decode import ops as jax_ops  # noqa: E402
from repro_torch.kernels.paged_decode import kernel as pt_kernel  # noqa: E402
from repro_torch.kernels.paged_decode import ops as pt_ops  # noqa: E402
from repro_torch.parallel.paged_attention import merge_shard_partials  # noqa: E402

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


def _mk_vm(rng, b, max_lpages, page_slots, lengths, shared_page0=False):
    """BlockManager-style tables: every live page of every sequence mapped
    to a distinct frame in scrambled order, optionally one read-only frame
    backing page 0 of every sequence (as tests/test_kernels.py:_mk_vm)."""
    n_frames = b * max_lpages
    bt = np.full((b, max_lpages), -1, np.int32)
    fl = np.zeros((n_frames,), np.int32)
    fr = np.zeros((n_frames,), bool)
    free = list(rng.permutation(n_frames))
    sh = None
    if shared_page0:
        sh = int(free.pop())
        fl[sh], fr[sh] = 0, True
    for s in range(b):
        for lp in range((int(lengths[s]) + page_slots - 1) // page_slots):
            if sh is not None and lp == 0:
                bt[s, 0] = sh
                continue
            f = int(free.pop())
            bt[s, lp], fl[f] = f, lp
    return bt, fl, fr


def _inputs(seed, *, b=3, max_lpages=4, page_slots=8, hkv=2, group=2,
            lengths=(25, 9, 17), shared_page0=False, write_mask=None):
    rng = np.random.default_rng(seed)
    hl, hd = hkv * group, 16
    n_frames = b * max_lpages
    lengths = np.asarray(lengths, np.int32)
    x = dict(
        q=rng.normal(size=(b, hl, hd)).astype(np.float32),
        k_new=rng.normal(size=(b, hkv, hd)).astype(np.float32),
        v_new=rng.normal(size=(b, hkv, hd)).astype(np.float32),
        kp=rng.normal(size=(n_frames, page_slots, hkv, hd)).astype(np.float32),
        vp=rng.normal(size=(n_frames, page_slots, hkv, hd)).astype(np.float32),
        lengths=lengths)
    x["bt"], x["fl"], x["fr"] = _mk_vm(rng, b, max_lpages, page_slots,
                                       lengths, shared_page0)
    x["wm"] = (np.ones(b, bool) if write_mask is None
               else np.asarray(write_mask, bool))
    return x, dict(group=group, max_pages=max_lpages)


def _jax_shard(x, kw, impl, window, use_vm):
    out = jax_ops.paged_decode_shard(
        *(jnp.asarray(x[k]) for k in ("q", "k_new", "v_new", "kp", "vp",
                                      "lengths", "bt", "fl", "fr", "wm")),
        sid=0, n_shards=1, head_start=0, group=kw["group"], window=window,
        max_pages=kw["max_pages"], use_vm=use_vm, impl=impl, interpret=True)
    return [np.asarray(o) for o in out]


def _pt_shard(x, kw, window, use_vm, sid=0, n_shards=1, kp=None, vp=None):
    t = {k: torch.tensor(v) for k, v in x.items()}
    out = pt_ops.paged_decode_shard(
        t["q"], t["k_new"], t["v_new"],
        t["kp"] if kp is None else kp, t["vp"] if vp is None else vp,
        t["lengths"], t["bt"], t["fl"], t["fr"], t["wm"], sid=sid,
        n_shards=n_shards, head_start=0, group=kw["group"], window=window,
        max_pages=kw["max_pages"], use_vm=use_vm, impl="composed")
    return [o.numpy() for o in out]


def _assert_match(port, ref):
    acc_p, m_p, l_p, kp_p, vp_p = port
    acc_r, m_r, l_r, kp_r, vp_r = ref
    np.testing.assert_array_equal(kp_p, kp_r)
    np.testing.assert_array_equal(vp_p, vp_r)
    np.testing.assert_allclose(m_p, m_r, **TOL)
    np.testing.assert_allclose(acc_p, acc_r, **TOL)
    np.testing.assert_allclose(l_p, l_r, **TOL)


CASES = {
    # ragged lengths, each with and without a window (test_kernels.py:184)
    **{f"ragged{lens}": (dict(lengths=lens), (None, 8), True)
       for lens in [(25, 9, 17), (1, 32, 8), (31, 2, 24)]},
    # dropped writes: shared read-only page 0 + a masked sequence (:197)
    "write-drop": (dict(lengths=(5, 3, 8), shared_page0=True,
                        write_mask=(True, True, False)), (None,), True),
    # one frame shared by every sequence is attended once by each (:217)
    "shared-frame": (dict(lengths=(25, 9, 17), shared_page0=True), (None,),
                     True),
    # no VM: the fixed arithmetic mapping (:228)
    "no-vm": (dict(lengths=(25, 9, 17)), (None,), False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_paged_decode_shard_matches_jax(case):
    """Port composed == JAX composed == JAX fused (interpret)."""
    inp, windows, use_vm = CASES[case]
    x, kw = _inputs(1234, **inp)
    for window in windows:
        port = _pt_shard(x, kw, window, use_vm)
        _assert_match(port, _jax_shard(x, kw, "composed", window, use_vm))
        _assert_match(port, _jax_shard(x, kw, "fused", window, use_vm))
    if case == "write-drop":
        # and the drop really happened: every page came through unchanged
        np.testing.assert_array_equal(port[3], x["kp"])


def test_kernel_wrappers_raise_on_cpu_tensors():
    """A CUDA kernel has no interpret mode: the wrappers refuse CPU tensors
    (the composed oracle is the CPU path) and count no launch."""
    x, kw = _inputs(99)
    t = {k: torch.tensor(v) for k, v in x.items()}
    b, hl, hd = x["q"].shape
    qg = t["q"].reshape(b, hl // kw["group"], kw["group"], hd)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        pt_kernel.paged_kv_write(t["k_new"], t["v_new"], t["kp"], t["vp"],
                                 t["bt"], t["lengths"], t["fr"], t["wm"],
                                 (0, 1, 0))
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        pt_kernel.paged_gather_attend(qg, t["kp"], t["vp"], t["bt"],
                                      t["lengths"], (0, 1, 0))
    np.testing.assert_array_equal(t["kp"].numpy(), x["kp"])
    assert pt_kernel.LAUNCHES == {"paged_kv_write": 0,
                                  "paged_gather_attend": 0}


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_emulated_shard_split_merges_to_one_shard(n_shards):
    """Frames spread cyclically over n_shards (frame f on shard f % S at
    row f // S): one call per sid on its local pages, merged with the
    log-sum-exp formula, equals the single-shard output, and the written
    pages land where the cyclic layout says (windows None and 8)."""
    for window in (None, 8):
        _check_shard_split(n_shards, window)


def _check_shard_split(n_shards, window):
    x, kw = _inputs(7, lengths=(25, 9, 17), shared_page0=True)
    one = _pt_shard(x, kw, window, True)
    kp, vp = torch.tensor(x["kp"]), torch.tensor(x["vp"])
    accs, ms, ls = [], [], []
    for sid in range(n_shards):
        kp_l, vp_l = kp[sid::n_shards].clone(), vp[sid::n_shards].clone()
        acc, m, l, kp_w, vp_w = _pt_shard(x, kw, window, True, sid=sid,
                                          n_shards=n_shards, kp=kp_l,
                                          vp=vp_l)
        accs.append(acc), ms.append(m), ls.append(l)
        np.testing.assert_array_equal(kp_w, one[3][sid::n_shards])
        np.testing.assert_array_equal(vp_w, one[4][sid::n_shards])
    merged = merge_shard_partials(torch.tensor(np.stack(accs)),
                                  torch.tensor(np.stack(ms)),
                                  torch.tensor(np.stack(ls)))
    full = merge_shard_partials(*(torch.tensor(a[None]) for a in one[:3]))
    np.testing.assert_allclose(merged.numpy(), full.numpy(), **TOL)


def test_resolve_impl():
    """'auto' takes the composed oracle on CPU tensors and the kernels on
    CUDA ones; 'fused' on the CPU raises (no interpret mode).  The kernels
    take whole KV-head groups and a shard inside one group (a
    tensor-parallel rank's heads at tp > Hkv: ``group % hl == 0``), so
    'auto' on CUDA tensors is 'fused' for both; a shard that straddles two
    groups without holding whole ones (``hl % group`` and ``group % hl``
    both non-zero) raises, but for 'composed' and for 'auto' on meta
    tensors (the dry-run's counting device), which take the composed
    oracle.  The fused step's head grouping follows (``kernel_group``)."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    meta = torch.device("meta")
    assert pt_ops.resolve_impl("auto", 8, 2, cpu) == "composed"
    assert pt_ops.resolve_impl("auto", 8, 2, cuda) == "fused"
    assert pt_ops.resolve_impl("composed", 8, 2, cuda) == "composed"
    assert pt_ops.resolve_impl("fused", 8, 2, cuda) == "fused"
    with pytest.raises(RuntimeError):
        pt_ops.resolve_impl("fused", 8, 2, cpu)
    # inside one group: danube / mixtral at tp 16 (hl 2, G 4), hl 1
    for hl, group in ((2, 4), (1, 4), (1, 2), (4, 8), (7, 7)):
        assert pt_ops.resolve_impl("auto", hl, group, cuda) == "fused"
        assert pt_ops.resolve_impl("fused", hl, group, cuda) == "fused"
        assert pt_ops.resolve_impl("auto", hl, group, cpu) == "composed"
    # straddling: raises on the kernels' path
    for hl, group in ((7, 2), (2, 7), (3, 2), (4, 6)):
        for flag, dev in (("auto", cuda), ("fused", cuda), ("fused", cpu),
                          ("auto", cpu)):
            with pytest.raises(ValueError):
                pt_ops.resolve_impl(flag, hl, group, dev)
        assert pt_ops.resolve_impl("auto", hl, group, meta) == "composed"
    assert pt_ops.resolve_impl("auto", 8, 2, meta) == "composed"
    for dev in (cpu, cuda, meta):
        assert pt_ops.resolve_impl("composed", 2, 7, dev) == "composed"
    assert [pt_ops.kernel_group(hl, g) for hl, g in
            ((8, 2), (2, 4), (1, 4), (2, 7), (4, 6))] == [2, 2, 1, None, None]
