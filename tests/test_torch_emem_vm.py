"""The port's EMemVM (``repro_torch.emem_vm``) against the JAX reference.

The same sequence of operations runs on the reference's ``EMemVM`` and on
the port's, with the same numpy inputs, and every ``vread`` output, the
``counters()``, ``stats()``, the page table, the hot-page cache and the
store must be identical.  The reference runs unsharded; the port runs
unsharded and over 2 emulated shards (its store compared through
``to_logical``), with the cache off and on: the tests/test_emem_vm.py
oracle sequence (random writes and reads with duplicates and unmapped
pages, then unmap and remap), protection bits, swap-out with faults, LRU
victims under a full pool and a bounded host store that spills, flush, and
per-requester isolation.  The port reads whole pages (cache fill,
swap-out) with K6's plain version where the reference reads slots; the
last test holds the slot route it takes when reads can drop.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import emem as jax_emem  # noqa: E402
from repro.emem_vm import cache as jax_cache  # noqa: E402
from repro.emem_vm import page_table as jax_pt  # noqa: E402
from repro.emem_vm import vm as jax_vm  # noqa: E402
from repro_torch.core import emem  # noqa: E402
from repro_torch.emem_vm import PROT_R, PROT_RW, PROT_W, EMemVM, VMConfig  # noqa: E402
from repro_torch.emem_vm import cache as t_cache  # noqa: E402
from repro_torch.emem_vm import page_table as t_pt  # noqa: E402
from repro_torch.emem_vm import vm as t_vm  # noqa: E402


class Twin:
    """One reference VM and one port VM driven in lockstep; every result
    is compared on the spot."""

    def __init__(self, cache_sets=0, n_requesters=1, sharded=False,
                 n_slots=1024, width=4, page_slots=16, **cfg_kw):
        kw = dict(n_slots=n_slots, width=width, page_slots=page_slots,
                  n_shards=2 if sharded else 1)
        jspec, self.spec = jax_emem.EMemSpec(**kw), emem.EMemSpec(**kw)
        vm_kw = dict(n_vpages=jspec.n_pages * 2, cache_sets=cache_sets,
                     n_requesters=n_requesters, **cfg_kw)
        self.ref = jax_vm.EMemVM(jax_vm.VMConfig(spec=jspec, **vm_kw))
        self.port = EMemVM(VMConfig(spec=self.spec, **vm_kw),
                           sharded=sharded, device="cpu")
        self.ps, self.width = page_slots, width

    def batch(self, *addrs):
        """``addrs`` padded to the rounds' 48 with the last virtual page,
        which no test maps: its reads give zeros and its writes drop.  One
        batch size keeps the reference's compiled operations reused."""
        filler = (self.port.cfg.n_vpages - 1) * self.ps
        out = np.full(48, filler, np.int32)
        flat = np.concatenate([np.ravel(a) for a in addrs]).astype(np.int32)
        out[:len(flat)] = flat
        return out

    def values(self, rng):
        return rng.normal(size=(48, self.width)).astype(np.float32)

    def __getattr__(self, name):
        """A control-plane call on both VMs, with equal results."""
        def call(*args):
            want = getattr(self.ref, name)(*args)
            assert getattr(self.port, name)(*args) == want, name
            return want
        return call

    def vwrite(self, addrs, vals, requester=0):
        self.ref.vwrite(jnp.asarray(addrs, jnp.int32), jnp.asarray(vals),
                        requester)
        self.port.vwrite(torch.tensor(addrs, dtype=torch.int32),
                         torch.tensor(vals), requester)

    def vread(self, addrs, requester=0):
        want = np.asarray(self.ref.vread(jnp.asarray(addrs, jnp.int32),
                                         requester))
        got = self.port.vread(torch.tensor(addrs, dtype=torch.int32),
                              requester).numpy()
        np.testing.assert_array_equal(got, want)
        return got

    def check(self):
        assert self.port.counters() == self.ref.counters()
        assert self.port.stats() == self.ref.stats()
        np.testing.assert_array_equal(self.port.page_table._host,
                                      self.ref.page_table._host)
        data = self.port.data
        if self.port.sharded:
            data = emem.to_logical(self.spec, data)
        np.testing.assert_array_equal(data.numpy(), np.asarray(self.ref.data))
        if self.ref.cache is not None:
            for key, want in self.ref.cache.items():
                np.testing.assert_array_equal(self.port.cache[key].numpy(),
                                              np.asarray(want), err_msg=key)

    def rounds(self, rng, n_rounds, requester=0):
        """tests/test_emem_vm.py's oracle rounds: 48 random addresses over
        the whole virtual space (unmapped pages included), a few repeated."""
        n = self.port.cfg.n_vpages * self.ps
        for _ in range(n_rounds):
            addrs = rng.integers(0, n, 48).astype(np.int32)
            addrs[1:4] = addrs[0]
            vals = rng.normal(size=(48, self.width)).astype(np.float32)
            self.vwrite(addrs, vals, requester)
            self.vread(addrs, requester)
            self.vread(rng.integers(0, n, 48).astype(np.int32), requester)


@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("cache_sets", [0, 4])
def test_vm_matches_reference(cache_sets, sharded):
    """The oracle sequence, unmap of half the pages, remap onto recycled
    frames (which carry their stale bytes), more rounds."""
    twin = Twin(cache_sets=cache_sets, sharded=sharded)
    rng = np.random.default_rng(7 + cache_sets)
    twin.map_range(0, 20)
    twin.rounds(rng, 4)
    for vp in range(0, 16, 2):
        twin.unmap_page(vp)
    twin.map_range(40, 8)
    twin.rounds(rng, 3)
    twin.check()


def test_vm_protection_bits_match_reference():
    twin = Twin(cache_sets=4)
    twin.map_page(0, PROT_RW)
    twin.map_page(1, PROT_R)
    twin.map_page(2, PROT_W)
    addrs = twin.batch([0, twin.ps, 2 * twin.ps])
    twin.vwrite(addrs, np.ones((48, twin.width), np.float32))
    out = twin.vread(addrs)
    np.testing.assert_array_equal(out[:3], [[1] * 4, [0] * 4, [0] * 4])
    twin.protect(2, PROT_RW)
    twin.vread(addrs)
    twin.check()


@pytest.mark.parametrize("sharded", [False, True])
def test_vm_swap_fault_lru_spill_match_reference(sharded):
    """A full pool, dirty cached lines, swap-outs through a 2-page host
    store into the spill tier, faults that evict LRU victims and promote
    spilled pages two-hop, unmap of a swapped page, flush."""
    twin = Twin(cache_sets=4, sharded=sharded, n_host_pages=2)
    rng = np.random.default_rng(21)
    usable = twin.port.allocator.n_frames
    twin.map_range(0, usable)                       # pool completely full
    heads = np.arange(usable, dtype=np.int32) * twin.ps
    twin.vwrite(heads[:48], twin.values(rng))
    twin.vwrite(heads[-48:], twin.values(rng))
    twin.vread(twin.batch(heads[:8] + 1))           # cache pages 0..7
    twin.vwrite(twin.batch(heads[:8] + 1), twin.values(rng))   # dirty them
    for vp in (0, 1, 2, 5):
        twin.swap_out(vp)
    twin.map_range(usable + 2, 4)                   # pool full again
    assert twin.port.stats()["spilled_pages"] == 2
    twin.vread(twin.batch(heads[:3] + 1, heads[10:12]))        # 3 faults
    twin.vwrite(twin.batch(heads[5] + 2), twin.values(rng))    # 1 more
    twin.unmap_page(int(np.flatnonzero(
        [twin.port.page_table.is_swapped(v) for v in range(usable)])[0]))
    twin.rounds(rng, 2)
    twin.flush()
    c = twin.port.counters()
    assert c["faults"] >= 4 and c["spill_ins"] >= 1 and c["swap_outs"] > 4
    twin.check()


def test_vm_per_requester_isolation_and_flush():
    twin = Twin(cache_sets=4, n_requesters=2, sharded=True)
    rng = np.random.default_rng(5)
    twin.map_range(0, 8)
    head = twin.batch([0, 1])
    twin.vread(head, requester=0)
    twin.vread(head, requester=0)
    twin.vread(head, requester=1)                   # a cold bank: misses
    assert twin.port.cache["hits"].tolist() == [2, 0]
    twin.rounds(rng, 2, requester=0)
    twin.rounds(rng, 1, requester=1)
    twin.flush()
    twin.check()
    raw = emem.read(twin.spec, twin.port.data, torch.tensor(head))
    np.testing.assert_array_equal(
        raw.numpy(), np.asarray(jax_emem.read_ref(
            twin.ref.cfg.spec, twin.ref.data, jnp.asarray(head))))


def test_page_table_and_cache_units_match_reference():
    rng = np.random.default_rng(9)
    for args in ((5, PROT_RW, True, False), (7, PROT_R, False, True),
                 ((1 << 24) + 3, PROT_W, True, False), (0, 0, False, False)):
        assert t_pt.pack_pte(*args) == jax_pt.pack_pte(*args)
    jt, tt = jax_pt.PageTable(10, 16), t_pt.PageTable(10, 16, device="cpu")
    for table in (jt, tt):
        table.map(3, 7, PROT_R)
        table.map(4, 2)
        table.mark_swapped(4)
    addrs = np.array([3 * 16 + 5, 4 * 16, 0, -3, 10 * 16, 1 << 20], np.int32)
    for got, want in zip(t_pt.translate(tt.entries, torch.tensor(addrs), 16),
                         jax_pt.translate(jt.entries, jnp.asarray(addrs), 16)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tt.as_emem().shape == jt.as_emem().shape
    spec = jax_cache.CacheSpec(1, 4, 8, 2)
    tspec = t_cache.CacheSpec(1, 4, 8, 2)
    frames = rng.integers(0, 12, 20).astype(np.int32)
    miss = rng.random(20) < 0.6
    np.testing.assert_array_equal(
        t_cache.HotPageCache.plan_fill(tspec, torch.tensor(frames),
                                       torch.tensor(miss)).numpy(),
        np.asarray(jax_cache.HotPageCache.plan_fill(
            spec, jnp.asarray(frames), jnp.asarray(miss))))


def test_page_reads_take_the_slot_route_when_reads_can_drop():
    """With a capacity factor below the shard count a page's slot reads can
    overflow their queues; the port then reads slots as the reference does
    (drops included), and K6's route otherwise gives the same bits as the
    reference's slot read."""
    jspec, spec = (m.EMemSpec(n_slots=256, width=3, page_slots=16, n_shards=2)
                   for m in (jax_emem, emem))
    rng = np.random.default_rng(11)
    phys = rng.normal(size=spec.global_shape()).astype(np.float32)
    frames = np.array([3, 7, 15], np.int32)
    addrs = (frames[:, None] * 16 + np.arange(16)).reshape(2, -1)
    local = jnp.asarray(phys).reshape(2, -1, 16, 3)
    for cf in (1.0, None):
        cfg = VMConfig(spec=spec, n_vpages=16, capacity_factor=cf)
        got = t_vm._mem_read_pages(cfg, True, torch.tensor(phys),
                                   torch.tensor(frames))
        cap = emem.capacity_for(spec, addrs.shape[1], cfg.cap_factor)
        want = jax.jit(jax.vmap(functools.partial(
            jax_emem.read_shard, jspec, ("x",), capacity=cap),
            axis_name="x"))(local, jnp.asarray(addrs))
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want).reshape(3, 16, 3))
        if cf is not None:
            assert not got.any(-1).all(), "cf=1 should drop slot reads"
