"""Logical-axis sharding rules (a port of ``repro.parallel.sharding``).

Model parameters carry tuples of logical axis names; a *rule set* maps
logical names to mesh axes.  A spec here is the reference's
``PartitionSpec`` as a plain tuple, one entry per tensor dim: ``None``
(replicated), a mesh axis name, or a tuple of names; :func:`placements`
turns it into ``torch.distributed.tensor`` placements over a
``DeviceMesh``, and :class:`NamedSharding` pairs the two (the reference's
``NamedSharding``: what a restore or the trainer places a tensor by).
Rule sets:

  fsdp_tp  -- training: weights sharded d_model over the DP axes (FSDP) and
              heads/mlp/experts/vocab over "model" (TP/EP); batch over DP.
  tp_only  -- serving: weights sharded over "model" only (no per-step FSDP
              all-gathers); batch over DP axes.
  dp_only  -- small models / debugging: weights replicated, batch over DP.

A mesh is a ``DeviceMesh`` or any object with a ``.shape`` dict of axis
sizes.

:func:`tp_shard_params` is the tensor-parallel split form of a decoder's
weights under ``tp_only``: one rank's whole-head, column, expert and vocab
shards (what :meth:`repro_torch.models.model.Model.shard` holds), where the
reference leaves the split to GSPMD.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Sequence

import torch

from repro_torch.launch.mesh import mesh_shape


def rule_set(name: str, dp_axes: Sequence[str] = ("data",),
             tp_axis: str = "model") -> dict:
    dp = tuple(dp_axes)
    if name == "fsdp_tp":
        return {
            "embed": dp, "q_heads": (tp_axis,), "kv_heads": (tp_axis,),
            "mlp": (tp_axis,), "experts": (tp_axis,), "vocab": (tp_axis,),
            "ssm_inner": (tp_axis,), "layers": (), "batch": dp, "seq": (),
        }
    if name == "tp_only":
        return {
            "embed": (), "q_heads": (tp_axis,), "kv_heads": (tp_axis,),
            "mlp": (tp_axis,), "experts": (tp_axis,), "vocab": (tp_axis,),
            "ssm_inner": (tp_axis,), "layers": (), "batch": dp, "seq": (),
        }
    if name == "dp_only":
        return {k: () for k in ("embed", "q_heads", "kv_heads", "mlp",
                                "experts", "vocab", "ssm_inner", "layers",
                                "seq")} | {"batch": dp}
    raise ValueError(f"unknown rule set {name!r}")


def spec_for(axes: tuple[str | None, ...], rules: dict, mesh=None,
             shape: tuple[int, ...] | None = None) -> tuple:
    """Spec of one parameter's logical axes.

    If ``mesh``+``shape`` are given, drops mesh axes that do not divide the
    dimension (falls back to replication for that dim) and never assigns the
    same mesh axis twice."""
    sizes = mesh_shape(mesh) if mesh is not None else None
    used: set[str] = set()
    parts: list[Any] = []
    for i, ax in enumerate(axes):
        assigned: tuple[str, ...] = ()
        if ax is not None and ax in rules:
            cand = tuple(a for a in rules[ax] if a not in used)
            if sizes is not None and shape is not None and cand:
                if shape[i] % math.prod(sizes[a] for a in cand) != 0:
                    cand = ()
            assigned = cand
        used.update(assigned)
        if len(assigned) == 0:
            parts.append(None)
        elif len(assigned) == 1:
            parts.append(assigned[0])
        else:
            parts.append(assigned)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


def _tree_map(fn: Callable, tree, *rest, is_leaf=_is_axes):
    """``fn`` over the leaves of nested dicts (and of trees shaped alike)."""
    if isinstance(tree, dict) and not is_leaf(tree):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest),
                             is_leaf=is_leaf) for k in tree}
    return fn(tree, *rest)


def params_pspecs(axes_tree, rules: dict, mesh=None, shapes_tree=None):
    """Map nested dicts of logical-axes tuples to specs (with
    ``shapes_tree``, leaves with a ``.shape``, the divisibility fallback)."""
    if shapes_tree is None:
        return _tree_map(lambda a: spec_for(a, rules, None, None), axes_tree)
    return _tree_map(lambda a, s: spec_for(a, rules, mesh, tuple(s.shape)),
                     axes_tree, shapes_tree)


def placements(spec: tuple, mesh) -> tuple:
    """``torch.distributed.tensor`` placements of ``spec`` over a
    ``DeviceMesh``: mesh dim ``a`` shards tensor dim ``i`` where ``a`` is
    in the spec's entry ``i``, and replicates otherwise.  A tensor dim
    split over several mesh dims must name them in the mesh's order (the
    row-major split DTensor gives)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        group = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"dim {i} splits over {group}, not in the mesh "
                             f"order {names}")
        for j in idx:
            out[j] = Shard(i)
    return tuple(out)


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A ``DeviceMesh`` and the placements of a tensor over it (one per
    mesh dim), in the role of the reference's ``NamedSharding``."""
    mesh: Any
    placements: tuple

    @classmethod
    def from_spec(cls, mesh, spec: tuple) -> "NamedSharding":
        return cls(mesh, placements(spec, mesh))

    def place(self, tensor):
        """``tensor`` (whole, the same on every rank) as a DTensor on the
        mesh's device type: each rank keeps a copy of its own shard, with
        no collective (``src_data_rank=None``), and holds nothing of the
        whole."""
        from torch.distributed.tensor import DTensor, distribute_tensor
        d = distribute_tensor(tensor.to(self.mesh.device_type), self.mesh,
                              self.placements, src_data_rank=None)
        local = d.to_local().clone(memory_format=torch.contiguous_format)
        return DTensor.from_local(local, self.mesh, self.placements,
                                  shape=d.shape, stride=d.stride(),
                                  run_check=False)


def params_shardings(axes_tree, rules: dict, mesh, shapes_tree=None):
    """:class:`NamedSharding` of every parameter over the ``DeviceMesh``."""
    specs = params_pspecs(axes_tree, rules, mesh, shapes_tree)
    return _tree_map(lambda s: NamedSharding.from_spec(mesh, s), specs,
                     is_leaf=lambda x: isinstance(x, tuple))


def batch_spec(rules: dict) -> tuple:
    dp = rules["batch"]
    return (dp if len(dp) > 1 else (dp[0] if dp else None),)


def maybe_constrain(x, axes: tuple):
    """The identity.  The reference steers GSPMD with a sharding constraint
    on activations (its value never changes); eager SPMD over process
    groups has no compiler to steer, and every rank already holds the
    activation it computes."""
    return x


def cache_pspecs(cache_shapes, mesh, *, dp_axes: Sequence[str],
                 tp_axis: str, kv_axes: Sequence[str]):
    """Specs for a serving cache (nested dicts keyed by leaf name).

    batch-layout k/v [L,B,Hkv,S,hd]: batch over DP; KV heads over TP when
    divisible, else the sequence dim over TP (flash-decode merge territory).
    paged k/v pages [L,NP,slots,Hkv,hd]: pages over the EMem owner axes.
    SSM states: batch over DP, heads/channels over TP when divisible.
    """
    sizes = mesh_shape(mesh)
    dp, kv = tuple(dp_axes), tuple(kv_axes)
    dp_n, tp_n = math.prod(sizes[a] for a in dp), sizes[tp_axis]
    dp_spec = dp if len(dp) > 1 else dp[0]
    kv_spec = kv if len(kv) > 1 else kv[0]

    def leaf_spec(name, leaf) -> tuple:
        shape = leaf.shape
        if name in ("k", "v", "xk", "xv"):
            l, b, hkv, s, hd = shape
            batch = dp_spec if b % dp_n == 0 else None
            if hkv % tp_n == 0:
                return (None, batch, tp_axis, None, None)
            if s % tp_n == 0:
                return (None, batch, None, tp_axis, None)
            return (None, batch, None, None, None)
        if name in ("k_pages", "v_pages"):
            return (None, kv_spec, None, None, None)
        if name == "conv":
            l, b, k_, c = shape
            batch = dp_spec if b % dp_n == 0 else None
            chan = tp_axis if c % tp_n == 0 else None
            return (None, batch, None, chan)
        if name == "ssd":
            l, b, h, n, pdim = shape
            batch = dp_spec if b % dp_n == 0 else None
            heads = tp_axis if h % tp_n == 0 else None
            return (None, batch, heads, None, None)
        return ()

    def walk(tree, name):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return leaf_spec(name, tree)

    return walk(cache_shapes, None)


# ---------------------------------------------------------------------------
# The tensor-parallel split form (serving, ``tp_only``)
# ---------------------------------------------------------------------------
def head_shard(n_heads: int, n_kv_heads: int, tp: int, index: int):
    """``(q_lo, q_hi, kv_lo, kv_hi)``: the query heads of tp rank ``index``
    and the KV heads they read, whole heads, or None where the heads stay
    whole on every rank.  Query heads split evenly, ``[index * hl, (index
    + 1) * hl)``; the KV heads are ``Hkv / tp`` of them where tp divides
    ``Hkv``, and where tp > Hkv the one KV head the rank's heads read, held
    by the ``tp / Hkv`` ranks that share it.  Heads tp does not divide, and
    a rank's heads that would straddle two KV-head groups without holding
    whole ones, stay whole."""
    if tp == 1 or n_heads % tp:
        return None
    hl, group = n_heads // tp, n_heads // n_kv_heads
    if hl % group and group % hl:
        return None
    q_lo = index * hl
    return q_lo, q_lo + hl, q_lo // group, (q_lo + hl - 1) // group + 1


def _block(size: int, tp: int, index: int):
    """Rank ``index``'s block of a dim of ``size`` split over ``tp``, or None
    where tp does not divide it (the dim stays whole, as :func:`spec_for`
    drops the axis)."""
    if tp == 1 or size % tp:
        return None
    n = size // tp
    return index * n, (index + 1) * n


def tp_shard_params(cfg, params: dict, axes: dict, tp: int,
                    index: int) -> dict:
    """Tp rank ``index``'s shards of a decoder's ``params`` (nested dicts of
    tensors, with their logical ``axes`` tree) under ``tp_only``: each
    ``q_heads`` / ``kv_heads`` dim (flat ``H * hd`` columns) to the rank's
    whole heads (:func:`head_shard`), ``mlp`` to its column block,
    ``experts`` to its block of experts where tp divides them (the
    ``mlp`` dim of those tensors then stays whole, as :func:`spec_for`
    assigns "model" once), ``vocab`` to its row or column block; the
    router stays whole (top-k needs every expert's score), as do
    ``embed``, the norms and every dim tp does not divide.  Returns new
    contiguous tensors (the whole ones can be freed)."""
    heads = head_shard(cfg.n_heads, cfg.n_kv_heads, tp, index)
    hd = cfg.hd

    def cut(name, ax, size, used):
        if ax in ("q_heads", "kv_heads"):
            if heads is None:
                return None
            lo, hi = heads[:2] if ax == "q_heads" else heads[2:]
            return lo * hd, hi * hd
        if ax == "experts" and name == "router":
            return None
        if ax in ("mlp", "experts", "vocab") and "tp" not in used:
            return _block(size, tp, index)
        return None

    def leaf(name, t, ax):
        used: set = set()
        for i, a in enumerate(ax):
            span = cut(name, a, t.shape[i], used)
            if span is not None:
                used.add("tp")
                t = t.narrow(i, span[0], span[1] - span[0])
        return t.clone(memory_format=torch.contiguous_format) if used else t

    def walk(tree, ax_tree):
        return {k: walk(v, ax_tree[k]) if isinstance(v, dict)
                else leaf(k, v, ax_tree[k]) for k, v in tree.items()}
    return walk(params, axes)
