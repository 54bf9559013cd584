"""EMem -- an executable emulated large memory over a collection of small
ones (a port of ``repro.core.emem``).

The paper's §2.1 emulation scheme: a flat logical address space of
``n_slots`` slots (each slot a ``width``-vector) is split into pages, and
pages are owned cyclically by ``n_shards`` small memories -- the
controller's distribution of "a contiguous address range ... over the
tiles".

Random-access reads and writes are communication sequences, vectorized: a
batch of addresses is binned by owner shard, routed to the owners (the
READ/WRITE request messages), served by a gather/scatter on the owner (the
DMA engine: the CUDA kernel K7 on the card, :mod:`repro_torch.kernels.
paged_decode.gather`) and routed back.  Each (requester, owner) pair gets a
fixed ``capacity`` of request slots, sized by a capacity factor, mirroring
a fixed-size hardware message queue; overflowing requests are dropped
(reads return 0), and :func:`dispatch_stats` gives the overflow
probability so callers can size the capacity.

Where the reference runs one shard per device under ``shard_map``, the port
runs ``n_shards`` emulated shards on one device: the store is the
reference's global array in physical (device-block) page order, so shard
``o`` owns pages ``o * pages_per_shard ... (o + 1) * pages_per_shard - 1``;
requester ``r`` issues chunk ``r`` of the address batch; the tiled
``all_to_all`` is a transpose of the [requester, owner] axes; and one K7
launch serves every owner's queue.  The results, drops included, are the
reference's on an ``n_shards``-device mesh.  Writes update the store in
place (the reference returns a new array; an 8 GiB copy per write is not
affordable) and still return it.

Addressing:
    page, offset = divmod(addr, page_slots)
    owner        = page %  n_shards          (cyclic distribution)
    local_page   = page // n_shards
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.paged_decode import gather_ops


@dataclasses.dataclass(frozen=True)
class EMemSpec:
    """Static description of an emulated memory."""
    n_slots: int                    # logical slots
    width: int                      # payload elements per slot
    page_slots: int = 128           # slots per page
    n_shards: int = 1               # small memories emulating the memory
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.n_slots % self.page_slots != 0:
            raise ValueError("n_slots must be a multiple of page_slots")
        if self.n_pages % self.n_shards != 0:
            raise ValueError("n_pages must be a multiple of n_shards")

    @property
    def n_pages(self) -> int:
        return self.n_slots // self.page_slots

    @property
    def pages_per_shard(self) -> int:
        return self.n_pages // self.n_shards

    @property
    def slots_per_shard(self) -> int:
        return self.pages_per_shard * self.page_slots

    @property
    def bytes_total(self) -> int:
        return self.n_slots * self.width * self.dtype.itemsize

    def global_shape(self) -> tuple[int, int, int]:
        return (self.n_pages, self.page_slots, self.width)

    def owner_of(self, addr):
        return (addr // self.page_slots) % self.n_shards

    def local_slot_of(self, addr):
        """Slot index within the owner's local [slots_per_shard, width] view."""
        page, offset = addr // self.page_slots, addr % self.page_slots
        return (page // self.n_shards) * self.page_slots + offset


def create(spec: EMemSpec, device=None) -> torch.Tensor:
    """A zero-initialized emulated memory on ``device`` (``cuda`` unless the
    caller names another)."""
    return torch.zeros(spec.global_shape(), dtype=spec.dtype,
                       device=resolve_device(device))


def capacity_for(spec: EMemSpec, n_requests_per_shard: int,
                 capacity_factor: float = 2.0) -> int:
    """Request-queue capacity per (requester, owner) pair."""
    mean = n_requests_per_shard / spec.n_shards
    cap = int(math.ceil(mean * capacity_factor))
    return max(1, min(cap, n_requests_per_shard))


# ---------------------------------------------------------------------------
# Reference (single logical view) paths -- the oracle for all tests
# ---------------------------------------------------------------------------
def _wrap(spec: EMemSpec, addrs: torch.Tensor) -> torch.Tensor:
    """NumPy-style negative indices, as JAX normalises them."""
    addrs = addrs.long()
    return torch.where(addrs < 0, addrs + spec.n_slots, addrs)


def read_ref(spec: EMemSpec, data: torch.Tensor,
             addrs: torch.Tensor) -> torch.Tensor:
    """Gather slots at ``addrs``: [R] -> [R, width].  As JAX's ``flat[addrs]``:
    a negative address counts from the end, and one still out of range reads
    the nearest end slot."""
    flat = data.view(spec.n_slots, spec.width)
    return flat.index_select(0, _wrap(spec, addrs).clamp(0, spec.n_slots - 1))


def write_ref(spec: EMemSpec, data: torch.Tensor, addrs: torch.Tensor,
              values: torch.Tensor) -> torch.Tensor:
    """``data[addrs] = values`` in place, as JAX's ``.at[addrs].set``: a
    negative address counts from the end, one still out of range is
    dropped, and the last of several writes to one slot wins."""
    return gather_ops.scatter_slots(data, _wrap(spec, addrs), values)


# ---------------------------------------------------------------------------
# Dispatch plan -- shared by read and write
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _Dispatch:
    owners: torch.Tensor     # [..., R] owner shard per request
    pos: torch.Tensor        # [..., R] slot within the (requester, owner) queue
    valid: torch.Tensor      # [..., R] fits within capacity
    send_addr: torch.Tensor  # [..., S, C] int32 local slot at owner (-1 = empty)


def _plan(spec: EMemSpec, addrs: torch.Tensor, capacity: int) -> _Dispatch:
    """The reference's plan of one requester's batch ``addrs`` [R]; leading
    dimensions, one per requester, plan several batches at once."""
    n_shards = spec.n_shards
    addrs = addrs.long()
    owners = spec.owner_of(addrs)                                  # [..., R]
    # queue positions: each owner's running count along the requests, kept
    # the innermost dimension (on the card a scan over an outer dimension
    # runs one thread per column, and took most of a 16-shard read)
    onehot = owners[..., None, :] == torch.arange(
        n_shards, device=addrs.device)[:, None]                    # [..., S, R]
    pos_all = onehot.long().cumsum(-1) - 1
    pos = pos_all.gather(-2, owners[..., None, :])[..., 0, :]
    valid = pos < capacity
    local_slot = spec.local_slot_of(addrs)
    # valid requests fill distinct (owner, pos) cells; the others land in a
    # dump cell past the end, which is cut off (the reference's mode="drop")
    cell = torch.where(valid, owners * capacity + pos, n_shards * capacity)
    send = torch.full((*addrs.shape[:-1], n_shards * capacity + 1), -1,
                      dtype=torch.int32, device=addrs.device)
    send.scatter_(-1, cell, local_slot.to(torch.int32))
    send_addr = send[..., :-1].reshape(*addrs.shape[:-1], n_shards, capacity)
    return _Dispatch(owners, pos, valid, send_addr)


# ---------------------------------------------------------------------------
# Shard bodies: every emulated shard at once
# ---------------------------------------------------------------------------
def _local_gather(spec: EMemSpec, local_data: torch.Tensor,
                  slots: torch.Tensor) -> torch.Tensor:
    """Gather slots of ``local_data`` [..., page_slots, width] (any number
    of pages); a negative slot returns zeros. [Q] -> [Q, width].  K7 on the
    card, its plain version on the CPU."""
    pages = local_data.view(-1, spec.page_slots, spec.width)
    return gather_ops.gather_slots(pages, slots)


def _local_scatter(spec: EMemSpec, local_data: torch.Tensor,
                   slots: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Scatter into ``local_data`` in place; negative and out-of-range slots
    are dropped, the last of several writes to one slot wins."""
    pages = local_data.view(-1, spec.page_slots, spec.width)
    gather_ops.scatter_slots(pages, slots, values)
    return local_data


def _owner_slots(spec: EMemSpec, recv_addr: torch.Tensor,
                 drop_past_end: bool) -> torch.Tensor:
    """Owner-local slots [S_owner, ...] as slots of the whole store: owner
    ``o``'s slot ``s`` is slot ``o * slots_per_shard + s``; -1 stays -1.  A
    local slot past the owner's end reads its last slot (JAX's clamped
    gather) or is dropped (its ``mode="drop"`` scatter)."""
    sps = spec.slots_per_shard
    owner = torch.arange(spec.n_shards, device=recv_addr.device).view(
        -1, *([1] * (recv_addr.dim() - 1)))
    slot = recv_addr.long()
    if drop_past_end:
        ok = (slot >= 0) & (slot < sps)
    else:
        ok, slot = slot >= 0, slot.clamp(max=sps - 1)
    return torch.where(ok, owner * sps + slot, -1).to(torch.int32)


def read_shard(spec: EMemSpec, local_data: torch.Tensor, addrs: torch.Tensor,
               capacity: int) -> torch.Tensor:
    """Distributed read body of every emulated shard at once.
    ``local_data``: the shards' pages [n_shards, pages_per_shard,
    page_slots, width]; ``addrs``: each requester's requests [n_shards, R].
    Returns [n_shards, R, width] (zeros for dropped/overflowed requests)."""
    if spec.n_shards == 1:
        return _local_gather(spec, local_data, addrs[0])[None]
    d = _plan(spec, addrs, capacity)
    recv_addr = d.send_addr.transpose(0, 1)        # all_to_all: [owner, req, C]
    served = _local_gather(spec, local_data,
                           _owner_slots(spec, recv_addr, False).reshape(-1))
    served = served.view(spec.n_shards, spec.n_shards, capacity, spec.width)
    recv_vals = served.transpose(0, 1)             # all_to_all: [req, owner, C, W]
    req = torch.arange(spec.n_shards, device=addrs.device)[:, None]
    out = recv_vals[req, d.owners, torch.where(d.valid, d.pos, 0)]
    return out.masked_fill(~d.valid[..., None], 0)


def write_shard(spec: EMemSpec, local_data: torch.Tensor, addrs: torch.Tensor,
                values: torch.Tensor, capacity: int) -> torch.Tensor:
    """Distributed write body of every emulated shard at once (shapes as
    :func:`read_shard`, ``values`` [n_shards, R, width]); updates
    ``local_data`` in place and returns it."""
    if spec.n_shards == 1:
        return _local_scatter(spec, local_data, addrs[0], values[0])
    s, w = spec.n_shards, spec.width
    d = _plan(spec, addrs, capacity)
    cell = torch.where(d.valid, d.owners * capacity + d.pos, s * capacity)
    send_vals = torch.zeros((s, s * capacity + 1, w), dtype=spec.dtype,
                            device=addrs.device)
    req = torch.arange(s, device=addrs.device)[:, None]
    send_vals[req, cell] = values.to(spec.dtype)
    send_vals = send_vals[:, :-1].view(s, s, capacity, w)
    recv_addr = d.send_addr.transpose(0, 1)        # all_to_all: [owner, req, C]
    recv_vals = send_vals.transpose(0, 1)
    return _local_scatter(spec, local_data,
                          _owner_slots(spec, recv_addr, True).reshape(-1),
                          recv_vals.reshape(-1, w))


# ---------------------------------------------------------------------------
# Store-level entry points (the reference's mesh-level wrappers)
# ---------------------------------------------------------------------------
def _split(spec: EMemSpec, data: torch.Tensor, addrs: torch.Tensor,
           capacity_factor: float):
    if addrs.shape[0] % spec.n_shards:
        raise ValueError(f"{addrs.shape[0]} requests do not split evenly over "
                         f"{spec.n_shards} requesters")
    r_shard = addrs.shape[0] // spec.n_shards
    local = data.view(spec.n_shards, spec.pages_per_shard, spec.page_slots,
                      spec.width)
    return (local, addrs.view(spec.n_shards, r_shard),
            capacity_for(spec, r_shard, capacity_factor))


def read(spec: EMemSpec, data: torch.Tensor, addrs: torch.Tensor,
         capacity_factor: float = 2.0) -> torch.Tensor:
    """Distributed random read of ``addrs`` (global [R], requester ``r``
    issuing chunk ``r``) from ``data`` in physical page order -> [R, width]."""
    local, addrs, cap = _split(spec, data, addrs, capacity_factor)
    return read_shard(spec, local, addrs, cap).reshape(-1, spec.width)


def write(spec: EMemSpec, data: torch.Tensor, addrs: torch.Tensor,
          values: torch.Tensor, capacity_factor: float = 2.0) -> torch.Tensor:
    """Distributed random write, in place; returns ``data``."""
    local, addrs, cap = _split(spec, data, addrs, capacity_factor)
    write_shard(spec, local, addrs,
                values.reshape(spec.n_shards, -1, spec.width), cap)
    return data


# ---------------------------------------------------------------------------
# Layout conversion: physical (block-sharded, cyclically owned) <-> logical
# ---------------------------------------------------------------------------
def _page_perm(spec: EMemSpec) -> np.ndarray:
    """physical row of logical page p = (p % S) * pages_per_shard + p // S."""
    p = np.arange(spec.n_pages)
    return (p % spec.n_shards) * spec.pages_per_shard + p // spec.n_shards


def to_logical(spec: EMemSpec, data: torch.Tensor) -> torch.Tensor:
    """Physical (device-block) page order -> logical page order (a copy)."""
    perm = torch.as_tensor(_page_perm(spec), device=data.device)
    return data.index_select(0, perm)


def from_logical(spec: EMemSpec, data: torch.Tensor) -> torch.Tensor:
    """Logical page order -> physical page order (a copy)."""
    inv = np.empty(spec.n_pages, np.int64)
    inv[_page_perm(spec)] = np.arange(spec.n_pages)
    return data.index_select(0, torch.as_tensor(inv, device=data.device))


# ---------------------------------------------------------------------------
# Analytics: expected traffic + overflow
# ---------------------------------------------------------------------------
def dispatch_stats(spec: EMemSpec, n_requests_per_shard: int,
                   capacity_factor: float = 2.0) -> dict:
    """Expected all-to-all bytes and binomial overflow bound for uniform
    random addressing (the paper's workload)."""
    itemsize = spec.dtype.itemsize
    cap = capacity_for(spec, n_requests_per_shard, capacity_factor)
    s = spec.n_shards
    addr_bytes = s * cap * 4
    val_bytes = s * cap * spec.width * itemsize
    # per-queue overflow: Binomial(R, 1/S) > C, normal-approximation tail
    mean = n_requests_per_shard / s
    if cap >= n_requests_per_shard or s == 1:
        p_overflow = 0.0
    else:
        var = n_requests_per_shard * (1.0 / s) * (1.0 - 1.0 / s)
        z = (cap - mean) / math.sqrt(max(var, 1e-12))
        p_overflow = 0.5 * math.erfc(z / math.sqrt(2.0))
    return {
        "capacity": cap,
        "a2a_bytes_per_shard": 2 * (addr_bytes + val_bytes),  # out + back
        "p_queue_overflow": p_overflow,
    }
