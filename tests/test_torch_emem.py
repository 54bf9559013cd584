"""The port's EMem (``repro_torch.core.emem``) against the JAX reference.

Exact comparisons on the same numpy inputs: ``_plan`` (owners, queue
positions, the drop mask and the request messages) in and out of overflow;
the emulated-shard ``read``/``write`` at 1, 2, 4 and 8 shards against the
reference's own shard bodies run over ``n_shards`` emulated devices
(``jax.vmap`` with a named axis carries their ``all_to_all``), against
``read_ref``/``write_ref`` and the reference's ``_plan(...).valid`` drops,
as tests/test_distributed.py does on device meshes; the layout conversion,
``dispatch_stats`` and ``capacity_for``; and the single-view
``read_ref``/``write_ref`` with duplicate, negative and out-of-range
addresses.  On the card the shard-local gather is the CUDA kernel K7
(chip_smoke.py phase emem); here it is its plain version.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import emem as jax_emem  # noqa: E402
from repro_torch.core import emem  # noqa: E402


def specs(n_shards, n_slots=512, width=4, page_slots=16):
    kw = dict(n_slots=n_slots, width=width, page_slots=page_slots,
              n_shards=n_shards)
    return jax_emem.EMemSpec(**kw), emem.EMemSpec(**kw)


def shard_bodies(jspec, fn, capacity):
    """The reference's shard body over ``n_shards`` emulated devices:
    [S, ...] per-shard arguments -> [S, ...] per-shard results."""
    return jax.jit(jax.vmap(
        functools.partial(fn, jspec, ("x",), capacity=capacity),
        axis_name="x"))


def ref_plans(jspec, addrs, capacity):
    """The reference's ``_plan`` of each requester's batch, addrs [S, R]:
    (owners, pos, valid, send_addr) as numpy, each with a leading S."""
    def plan(a):
        d = jax_emem._plan(jspec, a, capacity)
        return d.owners, d.pos, d.valid, d.send_addr
    return [np.asarray(x) for x in jax.jit(jax.vmap(plan))(jnp.asarray(addrs))]


@pytest.mark.parametrize("cf", [1.0, 4.0])
def test_plan_matches_reference(cf):
    """Out of overflow (capacity factor 4) and in it (1.0), for a batch and
    for several requesters' batches planned together."""
    rng = np.random.default_rng(int(cf))
    for n_shards in (1, 2, 4, 8):
        jspec, spec = specs(n_shards)
        addrs = rng.integers(0, spec.n_slots, (3, 64)).astype(np.int32)
        cap = emem.capacity_for(spec, 64, cf)
        got = emem._plan(spec, torch.tensor(addrs), cap)
        single = emem._plan(spec, torch.tensor(addrs[1]), cap)
        for key, want in zip(("owners", "pos", "valid", "send_addr"),
                             ref_plans(jspec, addrs, cap)):
            np.testing.assert_array_equal(getattr(got, key).numpy(), want,
                                          err_msg=(n_shards, key))
            np.testing.assert_array_equal(getattr(single, key).numpy(),
                                          want[1], err_msg=(n_shards, key))
        if n_shards > 1 and cf == 1.0:
            assert not got.valid.all(), "cf=1 should overflow"


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_emulated_shards_match_reference(n_shards):
    rng = np.random.default_rng(n_shards)
    jspec, spec = specs(n_shards)
    logical = rng.normal(size=spec.global_shape()).astype(np.float32)
    phys = np.asarray(jax_emem.from_logical(jspec, jnp.asarray(logical)))
    r = 128 // n_shards
    addrs = rng.integers(0, spec.n_slots, 128).astype(np.int32)
    addrs[5:9] = addrs[1]                          # duplicates in one batch
    # past the end: the owner's local read clamps, its write drops;
    # negative: a negative local slot, zeros or dropped
    addrs[40:45] = [spec.n_slots, spec.n_slots + 17, spec.n_slots + 300, -1,
                    -40]
    inside = (addrs >= 0) & (addrs < spec.n_slots)
    vals = rng.normal(size=(128, spec.width)).astype(np.float32)
    local = jnp.asarray(phys).reshape(n_shards, -1, spec.page_slots,
                                      spec.width)
    flat = logical.reshape(spec.n_slots, spec.width)
    for cf in (0.5, 2.0):
        cap = emem.capacity_for(spec, r, cf)
        # read: the reference's shard bodies, and read_ref with its drops
        got = emem.read(spec, torch.tensor(phys), torch.tensor(addrs), cf)
        want = shard_bodies(jspec, jax_emem.read_shard, cap)(
            local, jnp.asarray(addrs).reshape(n_shards, r))
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(want).reshape(128, spec.width))
        valid = ref_plans(jspec, addrs.reshape(n_shards, r), cap)[2]
        if n_shards == 1:                    # the local fast path never drops
            valid = np.ones_like(valid)
        np.testing.assert_array_equal(
            got.numpy()[inside],
            np.where(valid.reshape(-1, 1), flat[addrs % spec.n_slots],
                     0.0)[inside])
        # write, in place: the reference's shard bodies
        data = torch.tensor(phys)
        out = emem.write(spec, data, torch.tensor(addrs), torch.tensor(vals),
                         cf)
        assert out is data
        want = shard_bodies(jspec, jax_emem.write_shard, cap)(
            local, jnp.asarray(addrs).reshape(n_shards, r),
            jnp.asarray(vals).reshape(n_shards, r, spec.width))
        np.testing.assert_array_equal(
            data.numpy(), np.asarray(want).reshape(spec.global_shape()))
        if n_shards > 1 and cf == 0.5:
            assert not np.array_equal(
                emem.to_logical(spec, data).numpy(),
                np.asarray(jax_emem.write_ref(jspec, jnp.asarray(logical),
                                              jnp.asarray(addrs),
                                              jnp.asarray(vals)))), \
                "cf=0.5 should drop writes"


def test_ref_paths_duplicates_and_out_of_range():
    """read_ref/write_ref follow JAX's indexing: a negative address counts
    from the end, past the end a read clamps and a write drops, and the last
    of duplicate writes wins; writes are in place."""
    rng = np.random.default_rng(3)
    jspec, spec = specs(4)
    base = rng.normal(size=spec.global_shape()).astype(np.float32)
    n = spec.n_slots
    addrs = np.array([7, 7, 100, -1, -n, -n - 3, n, n + 9, 7, 100, 0],
                     np.int32)
    vals = rng.normal(size=(len(addrs), spec.width)).astype(np.float32)
    want = jax_emem.write_ref(jspec, jnp.asarray(base), jnp.asarray(addrs),
                              jnp.asarray(vals))
    data = torch.tensor(base)
    assert emem.write_ref(spec, data, torch.tensor(addrs),
                          torch.tensor(vals)) is data
    np.testing.assert_array_equal(data.numpy(), np.asarray(want))
    reads = np.array([0, 7, -1, -n, -n - 3, n, n + 9, 2 ** 30], np.int32)
    np.testing.assert_array_equal(
        emem.read_ref(spec, data, torch.tensor(reads)).numpy(),
        np.asarray(jax_emem.read_ref(jspec, want, jnp.asarray(reads))))


def test_layout_stats_and_capacity_match_reference():
    rng = np.random.default_rng(4)
    for n_shards, page_slots in ((1, 8), (2, 16), (4, 16), (8, 8), (8, 64)):
        jspec, spec = specs(n_shards, n_slots=1024, width=2,
                            page_slots=page_slots)
        a = rng.normal(size=spec.global_shape()).astype(np.float32)
        for port, ref in ((emem.to_logical, jax_emem.to_logical),
                          (emem.from_logical, jax_emem.from_logical)):
            np.testing.assert_array_equal(port(spec, torch.tensor(a)).numpy(),
                                          np.asarray(ref(jspec, a)))
        np.testing.assert_array_equal(emem._page_perm(spec),
                                      jax_emem._page_perm(jspec))
        for n_req, cf in ((4096, 1.5), (64, 2.0), (7, 0.5), (1, 8.0)):
            assert emem.capacity_for(spec, n_req, cf) == \
                jax_emem.capacity_for(jspec, n_req, cf)
            assert emem.dispatch_stats(spec, n_req, cf) == \
                jax_emem.dispatch_stats(jspec, n_req, cf)
    for kw in (dict(n_slots=1 << 24, width=128, page_slots=256, n_shards=16),
               dict(n_slots=1 << 22, width=128, page_slots=256,
                    n_shards=256)):
        j, t = jax_emem.EMemSpec(**kw), emem.EMemSpec(**kw)
        assert t.bytes_total == j.bytes_total
        assert emem.dispatch_stats(t, 4096, 1.5) == \
            jax_emem.dispatch_stats(j, 4096, 1.5)
    zero = emem.create(spec, device="cpu")
    assert zero.shape == spec.global_shape() and not zero.any()
