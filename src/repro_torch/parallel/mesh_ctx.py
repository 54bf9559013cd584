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
reference's ``_flat_axis_index``; and one over ``batch_axes``, whose
ranks hold their blocks of a batch's rows where the context says so
(``dp_rows``: the trainer's; :func:`dp_offsets` then gives an MoE block
the counts of the earlier dp ranks).  The collectives the port calls go
through :func:`all_to_all`, :func:`all_reduce` and :func:`all_gather`,
which count their calls in :data:`CALLS`; :func:`tp_sum`,
:func:`tp_gather`, :func:`to_region`, :func:`tp_sum_in_region` and
:func:`tp_max` are the ones the tensor-parallel split form
(:meth:`repro_torch.models.model.Model.shard`) calls over the installed
context's tp group.  gloo moves CUDA tensors only for ``all_reduce`` and
``broadcast``: over a gloo group :func:`all_gather` stages a CUDA tensor
through a host copy (counted the same), so two processes can share one
card over gloo while their compute stays on it.

Under autograd (a train step on the split form) the tp collectives carry
the three gradient rules of a tensor-parallel region, each a
``torch.autograd.Function`` over ``all_reduce`` alone:

  * :func:`to_region` -- the copy of a replicated activation into the
    region (before a column-split product): the identity forward, the
    gradient summed over tp backward (each rank's is its share's partial);
  * :func:`tp_sum` -- the row-parallel sum out of it (``wo``, ``w_down``,
    the MoE combine, Mamba2's ``w_out``, the vocab-split embedding): summed
    forward, the gradient passed through backward;
  * :func:`tp_sum_in_region` -- a sum read back inside the region (the
    gated norm's sum of squares, read by the rank's channels only): summed
    both ways.

Without grad they are the in-place sums the serving paths call.
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
    dp_group: Any                             # process group over batch_axes
    n_dp: int                                 # ranks over batch_axes
    dp_index: int                             # this rank's flat dp index
    #: the model's rows are this rank's block of a batch split over
    #: ``batch_axes`` (the trainer's, the dry-run's), not every row (the
    #: serving ranks'): an MoE block then fills capacity over the global
    #: batch (:func:`dp_offsets`)
    dp_rows: bool


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
                kv_axes: Sequence[str] | None = None,
                dp_rows: bool = False) -> MeshContext:
    """Install ``mesh`` with its axis assignment; every rank calls this
    together (it may make process groups).  ``dp_rows``: the model runs on
    the rank's rows of a batch split over ``batch_axes``."""
    global _CTX
    kv_axes = tuple(kv_axes if kv_axes is not None else batch_axes)
    kv_group = axes_group(mesh, kv_axes)
    kv_index = flat_index(mesh, kv_axes)
    if dist.get_rank(kv_group) != kv_index:
        raise ValueError(f"kv_axes {kv_axes} are not in the mesh's dim order: "
                         "the group's rank order would not be row-major")
    shape = mesh_shape(mesh)
    batch_axes = tuple(batch_axes)
    _CTX = MeshContext(mesh, batch_axes, tp_axis, kv_axes,
                       math.prod(shape[a] for a in kv_axes), shape[tp_axis],
                       kv_group, mesh.get_group(tp_axis), kv_index,
                       flat_index(mesh, (tp_axis,)),
                       axes_group(mesh, batch_axes),
                       math.prod(shape[a] for a in batch_axes),
                       flat_index(mesh, batch_axes), dp_rows)
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


def _tracked(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    """A new tensor: ``x`` summed over ``group``."""
    return all_reduce(x.clone(memory_format=torch.contiguous_format), "sum",
                      group)


class _ToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


class _RowSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumInRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


def tp_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the context's tp group (a row-parallel product's
    partial sums): in place, or under autograd a new tensor whose gradient
    passes through unsummed."""
    group = _tp_context().tp_group
    if _tracked(x):
        return _RowSum.apply(x, group)
    return all_reduce(x.contiguous(), "sum", group)


def to_region(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the input of a tp region: the identity, whose gradient is
    summed over the context's tp group (no collective without autograd)."""
    if not _tracked(x):
        return x
    return _ToRegion.apply(x, _tp_context().tp_group)


def tp_sum_in_region(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the context's tp group where the sum is read
    inside the region: under autograd its gradient is summed too."""
    group = _tp_context().tp_group
    if _tracked(x):
        return _SumInRegion.apply(x, group)
    return all_reduce(x.contiguous(), "sum", group)


def tp_max(x: torch.Tensor) -> torch.Tensor:
    """``x``'s elementwise max over the context's tp group, a new tensor
    carrying no gradient."""
    return all_reduce(x.detach().clone(memory_format=torch.contiguous_format),
                      "max", _tp_context().tp_group)


def tp_gather(x: torch.Tensor) -> torch.Tensor:
    """Every tp rank's ``x``, stacked in tp order: [tp, *x.shape]."""
    return all_gather(x, _tp_context().tp_group)


def dp_ranks() -> int:
    """The dp ranks whose rows make up the model's batch: the installed
    context's, where its rows are split over them (``dp_rows``), else 1."""
    ctx = _CTX
    return ctx.n_dp if ctx is not None and ctx.dp_rows else 1


def dp_offsets(counts: torch.Tensor) -> torch.Tensor:
    """Each column of ``counts`` [E] (int32, this rank's) summed over the
    dp ranks before this one, in dp order: one all-reduce of an [n_dp, E]
    table that holds this rank's row and zeros (gloo stages a CUDA
    all_gather through the host; an all-reduce it runs on the device).
    Integers, outside autograd.  Needs :func:`dp_ranks` > 1."""
    ctx = _CTX
    table = counts.new_zeros((ctx.n_dp,) + tuple(counts.shape))
    table[ctx.dp_index] = counts
    all_reduce(table, "sum", ctx.dp_group)
    return table[:ctx.dp_index].sum(0, dtype=counts.dtype)
