"""The port's Mamba2 SSD scan (K5's plain version and its dispatch) against
the JAX reference, at the sizes of tests/test_kernels.py's SSD tests.

``ref.ssd_chunked`` -- K5's one plain version, what ``ops.ssd`` runs on CPU
tensors -- matches the reference's Pallas kernel in interpret mode (y) and
the reference's ``ssd_chunked`` (y and the final state) within 1e-4 in f32
and 3e-2 in bf16, the tolerances of tests/test_kernels.py:251; a tail
length the reference cannot take (S = 60, chunk 16) matches the
sequential ``ssd_scan`` within 1e-5 in f32; the decode step chains like the
reference's.  The CUDA kernel itself runs only on the card (chip_smoke.py
phase ssd); here its wrapper must refuse CPU tensors.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels.mamba2_ssd import kernel as jax_ssd_k  # noqa: E402
from repro.kernels.mamba2_ssd import ref as jax_ssd_ref  # noqa: E402
from repro_torch.kernels.mamba2_ssd import kernel as K5  # noqa: E402
from repro_torch.kernels.mamba2_ssd import ops, ref  # noqa: E402

torch.set_num_threads(2)

TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _inputs(seed, bt, s, h, p, n, groups):
    """f32 numpy inputs in the reference tests' distributions."""
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.normal(size=(bt, s, h, p)).astype(np.float32),
        dt=rng.uniform(0.01, 0.2, size=(bt, s, h)).astype(np.float32),
        A=-rng.uniform(0.5, 2.0, size=(h,)).astype(np.float32),
        B=rng.normal(size=(bt, s, groups, n)).astype(np.float32),
        C=rng.normal(size=(bt, s, groups, n)).astype(np.float32),
        D=rng.normal(size=(h,)).astype(np.float32))


def _both(a, dtype):
    """(jax array, torch tensor) of numpy ``a``; x, B and C in ``dtype``
    (both round the same f32 values to bf16), dt, A, D in f32."""
    names = ("x", "dt", "A", "B", "C", "D")
    jx = {k: jnp.asarray(a[k], dtype if k in "xBC" else jnp.float32)
          for k in names}
    tdt = getattr(torch, dtype)
    tx = {k: torch.tensor(a[k]).to(tdt if k in "xBC" else torch.float32)
          for k in names}
    return [jx[k] for k in names], [tx[k] for k in names]


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got.float() if hasattr(got, "float")
                                          else got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("chunk,groups", [(8, 1), (8, 2), (16, 1), (16, 2)])
def test_plain_matches_jax_kernel_and_chunked(chunk, groups):
    """y against the reference's Pallas kernel (interpret mode) and y and
    the final state against its ssd_chunked, in f32 and bf16."""
    a = _inputs(chunk + groups, 2, 64, 4, 8, 16, groups)
    for dtype in ("float32", "bfloat16"):
        jargs, targs = _both(a, dtype)
        y, state = ops.ssd(*targs, chunk=chunk)
        assert y.dtype == targs[0].dtype and state.dtype == torch.float32
        want_y = jax_ssd_k.ssd(*jargs, chunk=chunk, interpret=True)
        _close(y, want_y, TOL[dtype], f"y vs kernel {dtype}")
        ry, rstate = jax_ssd_ref.ssd_chunked(*jargs, chunk=chunk)
        _close(y, ry, TOL[dtype], f"y vs ssd_chunked {dtype}")
        _close(state, rstate, TOL[dtype], f"state vs ssd_chunked {dtype}")


def test_tail_length_matches_sequential_scan():
    """S = 60 with chunk 16: the tail chunk is padded with dt = 0, so y and
    the final state equal the sequential scan's (the reference's chunked
    paths assert S % chunk == 0)."""
    a = _inputs(5, 2, 60, 4, 8, 16, 2)
    jargs, targs = _both(a, "float32")
    want_y, want_state = jax_ssd_ref.ssd_scan(*jargs)
    for y, state in (ops.ssd(*targs, chunk=16),
                     ref.ssd_chunked(*targs, chunk=16)):
        _close(y, want_y, 1e-5, "y")
        _close(state, want_state, 1e-5, "state")
    y, state = ref.ssd_scan(*targs)
    _close(y, want_y, 1e-5, "port ssd_scan y")
    _close(state, want_state, 1e-5, "port ssd_scan state")


def test_decode_chain_matches_jax():
    """The port's ssd_decode_step, chained over S tokens, against the
    reference's step by step, and the chain's end against ssd_chunked."""
    a = _inputs(7, 2, 8, 4, 8, 16, 2)
    jargs, targs = _both(a, "float32")
    jx, jdt, jA, jB, jC, jD = jargs
    tx, tdt, tA, tB, tC, tD = targs
    jstate = jnp.zeros((2, 4, 16, 8))
    tstate = torch.zeros((2, 4, 16, 8))
    for t in range(8):
        jy, jstate = jax_ssd_ref.ssd_decode_step(
            jx[:, t], jdt[:, t], jA, jB[:, t], jC[:, t], jD, jstate)
        ty, tstate = ops.ssd_decode_step(tx[:, t], tdt[:, t], tA, tB[:, t],
                                         tC[:, t], tD, tstate)
        _close(ty, jy, 1e-5, f"y at {t}")
        _close(tstate, jstate, 1e-5, f"state at {t}")
    _, chunk_state = ops.ssd(*targs, chunk=4)
    _close(tstate, chunk_state, 1e-5, "chain end vs chunked")


def test_kernel_refuses_cpu_tensors():
    """A CUDA kernel has no interpret mode: the wrapper and an explicit
    ``use_kernel=True`` raise on CPU tensors, counting no launch."""
    _, targs = _both(_inputs(9, 1, 8, 2, 4, 4, 1), "float32")
    K5.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        K5.ssd(*targs, chunk=8)
    with pytest.raises(ValueError, match="CUDA"):
        ops.ssd(*targs, chunk=8, use_kernel=True)
    assert K5.LAUNCHES["ssd"] == 0
