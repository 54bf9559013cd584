"""Physical layout of the emulated-memory page pool: ONE home for the
cyclic frame distribution.

Shard ``f % n_shards`` of the ``kv_axes`` mesh axes holds frame ``f`` at
local row ``f // n_shards`` -- the paper's round-robin emulated-memory
addressing.  Host-side page movers (swap, COW, spill: the ``PageIO``
callbacks the serving engine hands :class:`repro_torch.emem_vm.BlockManager`),
the shard_map dispatch in ``repro_torch.parallel.paged_attention``, and the
composed oracle in ``repro_torch.kernels.paged_decode.ref`` must all agree on
this mapping; a multi-shard addressing bug once came from it being spelled
out twice, so spell it out once.  (The fused Pallas kernels walk the same
mapping in-grid: ``row = f // n_shards`` on the shard where
``f % n_shards == sid``.)

Pure arithmetic -- works on numpy arrays, jnp arrays, and traced values.
"""
from __future__ import annotations


def frame_rows(frames, n_pages: int, n_shards: int):
    """Frame id -> row of the *global* (shard-concatenated) pages array.

    The shard_map global array concatenates the per-shard blocks, so frame
    ``f`` lands at global row ``(f % S) * (n_pages // S) + f // S``.
    Identity for a single shard."""
    if n_shards == 1:
        return frames
    return (frames % n_shards) * (n_pages // n_shards) + frames // n_shards


def shard_frames(local_rows, sid, n_shards: int):
    """Local row -> global frame id on shard ``sid`` (inverse, per shard):
    row ``r`` of shard ``s`` holds frame ``r * S + s``."""
    return local_rows * n_shards + sid
