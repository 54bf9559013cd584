"""The port's emulated-memory gathers and scatter against the JAX reference.

``gather_ref.gather_slots``/``gather_pages`` -- the plain versions of K7 and
K6, what ``gather_ops`` runs on CPU tensors -- equal the reference's Pallas
kernels in interpret mode and its jnp oracle bit for bit (a gather does no
arithmetic), in f32 and bf16, at tests/test_kernels.py's sweep shapes and at
rows of 1, 3 and 4 elements, with empty (-1) and duplicate indices; an
index past the end reads the last row or page, as the oracle's clamped
gather does.  ``scatter_slots`` equals the reference's in-order scatter:
negative and out-of-range slots drop, and the last of several writes to
one slot wins.  The CUDA kernels run only on the card (chip_smoke.py phase
gather); here their wrappers must refuse CPU tensors.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels.paged_decode import gather as jax_k  # noqa: E402
from repro.kernels.paged_decode import gather_ref as jax_ref  # noqa: E402
from repro_torch.kernels.paged_decode import gather as K  # noqa: E402
from repro_torch.kernels.paged_decode import gather_ops, gather_ref  # noqa: E402

#: tests/test_kernels.py's sweep shapes, then rows of 1, 3 and 4 elements
SHAPES = [(4, 8, 16), (8, 16, 4), (2, 32, 128), (6, 8, 1), (5, 4, 3)]


def bits(x):
    """Raw bits of a JAX or torch f32/bf16/int32 array, as numpy."""
    if isinstance(x, torch.Tensor):
        x = x.view({torch.bfloat16: torch.int16, torch.float32: torch.int32,
                    torch.int32: torch.int32}[x.dtype])
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def both(a, dtype):
    """(jax array, torch tensor) of numpy ``a`` in ``dtype``; both round the
    same f32 values to bf16."""
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.tensor(a).to(getattr(torch, dtype)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_slots_matches_reference(dtype):
    rng = np.random.default_rng(0)
    for n_pages, ps, width in SHAPES:
        jp, tp = both(rng.normal(size=(n_pages, ps, width)).astype(np.float32),
                      dtype)
        n = n_pages * ps
        slots = np.concatenate([rng.integers(0, n, 17), [-1, 3, 3, n - 1, -1]]
                               ).astype(np.int32)
        got = gather_ref.gather_slots(tp, torch.tensor(slots))
        kern = jax_k.gather_slots(jp, jnp.asarray(slots), interpret=True)
        np.testing.assert_array_equal(bits(got), bits(kern))
    # past the end: the oracle's clamped gather reads the last slot
    far = np.array([n, n + 5, 2 ** 30, -2], np.int32)
    np.testing.assert_array_equal(
        bits(gather_ops.gather_slots(tp, torch.tensor(far))),
        bits(jax_ref.gather_slots(jp, jnp.asarray(far))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_pages_matches_reference(dtype):
    rng = np.random.default_rng(1)
    for n_pages, ps, width in [(6, 8, 32), (8, 16, 4), (6, 8, 1), (5, 4, 3)]:
        jp, tp = both(rng.normal(size=(n_pages, ps, width)).astype(np.float32),
                      dtype)
        ids = np.array([n_pages - 1, -1, 0, 3, 0, -5], np.int32)
        got = gather_ref.gather_pages(tp, torch.tensor(ids))
        kern = jax_k.gather_pages(jp, jnp.asarray(ids), interpret=True)
        np.testing.assert_array_equal(bits(got), bits(kern))
    far = np.array([n_pages, 2 ** 30, -1], np.int32)
    np.testing.assert_array_equal(
        bits(gather_ops.gather_pages(tp, torch.tensor(far))),
        bits(jax_ref.gather_pages(jp, jnp.asarray(far))))


def test_scatter_slots_duplicates_and_drops_match_reference():
    """Duplicates resolve to the last write, -1 and past-the-end drop, and
    the store is updated in place."""
    rng = np.random.default_rng(2)
    base = rng.normal(size=(4, 8, 3)).astype(np.float32)
    slots = np.array([5, 9, 5, -1, 31, 32, 9, 5, 0, 40, 17, 17], np.int32)
    vals = rng.normal(size=(len(slots), 3)).astype(np.float32)
    want = jax_ref.scatter_slots(jnp.asarray(base), jnp.asarray(slots),
                                 jnp.asarray(vals))
    pages = torch.tensor(base)
    out = gather_ops.scatter_slots(pages, torch.tensor(slots),
                                   torch.tensor(vals))
    assert out is pages
    np.testing.assert_array_equal(bits(pages), bits(want))
    # round trip, as tests/test_kernels.py's
    slots = rng.permutation(32)[:10].astype(np.int32)
    vals = rng.normal(size=(10, 3)).astype(np.float32)
    gather_ref.scatter_slots(pages, torch.tensor(slots), torch.tensor(vals))
    np.testing.assert_array_equal(
        gather_ref.gather_slots(pages, torch.tensor(slots)).numpy(), vals)


def test_cuda_wrappers_raise_on_cpu_tensors():
    pages = torch.zeros(4, 8, 16)
    idx = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        K.gather_slots(pages, idx)
    with pytest.raises(ValueError, match="CUDA"):
        K.gather_pages(pages, idx)
    assert K.LAUNCHES == {"gather_slots": 0, "gather_pages": 0}
