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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Sequence

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
        import torch
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
