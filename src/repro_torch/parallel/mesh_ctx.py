"""Process-wide mesh context (a port of ``repro.parallel.mesh_ctx``).

The launcher (or a test) installs the active ``DeviceMesh`` plus the axis
assignment once; code that needs explicit collectives (the paged decode
path, its page movers) reads it from here.  When no context is installed,
callers take their single-device paths.

Where the reference's ``shard_map`` bodies name mesh axes, a rank here
holds process groups: one over ``kv_axes`` (the EMem page owners; when they
name several mesh dims, one group per slice of the other dims, made with
``dist.new_group`` by every rank in the same order) and one over
``tp_axis``, plus its own index in each: over ``kv_axes`` row-major, as the
reference's ``_flat_axis_index``.  The collectives the port calls go
through :func:`all_to_all`, :func:`all_reduce` and :func:`all_gather`,
which count their calls in :data:`CALLS`; :func:`tp_sum` and
:func:`tp_gather` are the two the tensor-parallel split form
(:meth:`repro_torch.models.model.Model.shard`) calls over the installed
context's tp group.  gloo moves CUDA tensors only for ``all_reduce`` and
``broadcast``: over a gloo group :func:`all_gather` stages a CUDA tensor
through a host copy (counted the same), so two processes can share one
card over gloo while their compute stays on it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import mesh_shape

#: collective calls since the last :func:`reset_calls`
CALLS = {"all_to_all": 0, "all_reduce": 0, "all_gather": 0}


def reset_calls() -> None:
    for name in CALLS:
        CALLS[name] = 0


@dataclasses.dataclass(frozen=True)
class MeshContext:
    """The installed mesh and what a rank reads of it on every step (the
    sizes are kept: ``DeviceMesh.mesh`` builds a tensor per access)."""
    mesh: Any                                 # torch DeviceMesh
    batch_axes: tuple[str, ...]               # DP/FSDP axes
    tp_axis: str                              # tensor-parallel axis
    kv_axes: tuple[str, ...]                  # EMem page-owner axes
    n_kv_shards: int                          # ranks over kv_axes
    tp: int                                   # ranks over tp_axis
    kv_group: Any                             # process group over kv_axes
    tp_group: Any                             # process group over tp_axis
    kv_index: int                             # this rank's flat kv index
    tp_index: int                             # this rank's tp index


#: groups over several mesh dims, made once per (mesh, axes)
_GROUPS: dict = {}


def flat_index(mesh, axes: Sequence[str]) -> int:
    """This rank's index over ``axes``, row-major (the reference's
    ``_flat_axis_index``)."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    shape = mesh_shape(mesh)
    idx = 0
    for a in axes:
        idx = idx * shape[a] + coord[a]
    return idx


def axes_group(mesh, axes: Sequence[str]):
    """The process group of this rank over the mesh dims ``axes``.  One dim
    is the mesh's own group; several are made with ``dist.new_group``, one
    group per slice of the other dims, which every rank must enter in the
    same order (all ranks call this together)."""
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    names = tuple(mesh.mesh_dim_names)
    ranks = mesh.mesh
    key = (names, tuple(ranks.shape), tuple(ranks.flatten().tolist()), axes)
    if key not in _GROUPS:
        rest = [names.index(a) for a in names if a not in axes]
        own = [names.index(a) for a in axes]
        rows = ranks.permute(*rest, *own).reshape(
            -1, math.prod(ranks.shape[i] for i in own))
        me = dist.get_rank()
        for row in rows.tolist():
            group = dist.new_group(row)
            if me in row:
                _GROUPS[key] = group
    return _GROUPS[key]


def forget_groups() -> None:
    """Drop the groups :func:`axes_group` made (their default group has
    ended, or is about to)."""
    _GROUPS.clear()


_CTX: MeshContext | None = None


def set_context(mesh, *, batch_axes: Sequence[str] = ("data",),
                tp_axis: str = "model",
                kv_axes: Sequence[str] | None = None) -> MeshContext:
    """Install ``mesh`` with its axis assignment; every rank calls this
    together (it may make process groups)."""
    global _CTX
    kv_axes = tuple(kv_axes if kv_axes is not None else batch_axes)
    kv_group = axes_group(mesh, kv_axes)
    kv_index = flat_index(mesh, kv_axes)
    if dist.get_rank(kv_group) != kv_index:
        raise ValueError(f"kv_axes {kv_axes} are not in the mesh's dim order: "
                         "the group's rank order would not be row-major")
    shape = mesh_shape(mesh)
    _CTX = MeshContext(mesh, tuple(batch_axes), tp_axis, kv_axes,
                       math.prod(shape[a] for a in kv_axes), shape[tp_axis],
                       kv_group, mesh.get_group(tp_axis), kv_index,
                       flat_index(mesh, (tp_axis,)))
    return _CTX


def get_context() -> MeshContext | None:
    return _CTX


def clear_context() -> None:
    global _CTX
    _CTX = None


# ---------------------------------------------------------------------------
# Counted collectives
# ---------------------------------------------------------------------------
def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Tiled all_to_all on the leading dim: block ``j`` of ``x`` goes to
    group rank ``j``, block ``i`` of the result came from rank ``i``."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    CALLS["all_to_all"] += 1
    return out


def all_reduce(x: torch.Tensor, op: str, group) -> torch.Tensor:
    """``x`` reduced over ``group`` (``op`` "sum" or "max"), in place."""
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
    dist.all_reduce(x, op=ops[op], group=group)
    CALLS["all_reduce"] += 1
    return x


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every group rank's ``x``, stacked in rank order: [n, *x.shape].  A
    CUDA tensor over a gloo group goes through a host copy and comes back
    to its device."""
    staged = x.device.type == "cuda" and dist.get_backend(group) == "gloo"
    y = x.cpu() if staged else x.contiguous()
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, y, group=group)
    CALLS["all_gather"] += 1
    out = torch.stack(parts)
    return out.to(x.device) if staged else out


def _tp_context() -> MeshContext:
    if _CTX is None:
        raise RuntimeError("the tensor-parallel split form needs a mesh "
                           "context (mesh_ctx.set_context)")
    return _CTX


def tp_index() -> int:
    """This rank's index over the context's tp axis."""
    return _tp_context().tp_index


def tp_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the context's tp group (a row-parallel product's
    partial sums), in place."""
    return all_reduce(x.contiguous(), "sum", _tp_context().tp_group)


def tp_gather(x: torch.Tensor) -> torch.Tensor:
    """Every tp rank's ``x``, stacked in tp order: [tp, *x.shape]."""
    return all_gather(x, _tp_context().tp_group)
