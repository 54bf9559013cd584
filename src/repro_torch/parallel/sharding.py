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

:func:`tp_shard_params` is the tensor-parallel split form of a model's
weights under ``tp_only``: one rank's whole-head, column, expert, SSM-head
and vocab shards (what :meth:`repro_torch.models.model.Model.shard`
holds), where the reference leaves the split to GSPMD.
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


@dataclasses.dataclass(frozen=True, eq=False)
class Cut:
    """What a tensor-parallel rank's split form holds of one whole leaf:
    the positions ``index`` (a span ``[lo, hi)`` where ``index`` is None)
    along ``dim``, or the whole leaf where ``dim`` is None.  ``summed``
    marks a whole leaf read inside a split region -- by the rank's share of
    the work only (``q_norm``/``k_norm`` of split heads, the router and the
    shared gate of a split MoE block) -- whose gradient is partial on each
    rank and summed over tp; a whole leaf read on the replicated residual
    stream (the norms, an unsplit embedding) takes its full gradient on
    every rank.  A cut leaf's gradient is its positions' share: where
    several ranks hold a position (a KV head at tp > Hkv, the B and C
    columns of a Mamba2 mixer) each holds a partial of it."""
    dim: int | None = None
    lo: int = 0
    hi: int = 0
    index: torch.Tensor | None = None
    summed: bool = False

    def span(self) -> tuple[int, int] | None:
        """``(lo, hi)`` where the positions are contiguous, else None."""
        if self.index is None:
            return self.lo, self.hi
        idx = self.index
        if idx.numel() and bool((idx == torch.arange(
                int(idx[0]), int(idx[0]) + idx.numel())).all()):
            return int(idx[0]), int(idx[0]) + idx.numel()
        return None

    def take(self, t: torch.Tensor) -> torch.Tensor:
        """The rank's part of the whole leaf ``t``: ``t`` itself where the
        cut is whole, else a new contiguous tensor."""
        if self.dim is None:
            return t
        if self.index is None:
            t = t.narrow(self.dim, self.lo, self.hi - self.lo)
        else:
            t = t.index_select(self.dim, self.index.to(t.device))
        return t.clone(memory_format=torch.contiguous_format)

    def put(self, whole: torch.Tensor, part: torch.Tensor) -> torch.Tensor:
        """``part`` written into its positions of ``whole``, in place."""
        if self.dim is None:
            return whole.copy_(part)
        if self.index is None:
            whole.narrow(self.dim, self.lo, self.hi - self.lo).copy_(part)
            return whole
        return whole.index_copy_(self.dim, self.index.to(whole.device), part)


WHOLE = Cut()


def _ssm_cuts(cfg, shapes: dict, tp: int, index: int) -> dict:
    """The cuts of :func:`ssm_shard` for a Mamba2 mixer's leaves (of
    ``shapes``: one layer's, or stacked over periods)."""
    heads = head_shard(cfg.ssm_heads, cfg.ssm_groups, tp, index)
    if heads is None:
        return {name: WHOLE for name in shapes}
    h_lo, h_hi, g_lo, g_hi = heads
    pd, n = cfg.ssm_head_dim, cfg.ssm_state
    di, gn = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state

    def span(base, lo, hi, width):
        return torch.arange(base + lo * width, base + hi * width)
    x = span(0, h_lo, h_hi, pd)
    bc = torch.cat([span(di, g_lo, g_hi, n), span(di + gn, g_lo, g_hi, n)])
    conv = torch.cat([x, bc])
    cols = {"w_in": torch.cat([x, di + conv, span(2 * di + 2 * gn, h_lo,
                                                  h_hi, 1)]),
            "conv_w": conv, "conv_b": conv}
    out = {}
    for name, t in shapes.items():
        last = len(t.shape) - 1
        if name == "w_out":
            out[name] = Cut(last - 1, h_lo * pd, h_hi * pd)
        elif name == "norm_w":
            out[name] = Cut(last, h_lo * pd, h_hi * pd)
        elif name in cols:
            out[name] = Cut(last, index=cols[name])
        else:                            # a_log, dt_bias, d_skip: per head
            out[name] = Cut(last, h_lo, h_hi)
    return out


def ssm_shard(cfg, p: dict, tp: int, index: int) -> dict:
    """Tp rank ``index``'s shard of a Mamba2 mixer's weights ``p`` (one
    layer's, or stacked over periods on a leading dim): its block of SSM
    heads ``[h_lo, h_hi)`` (:func:`head_shard` over the heads and their
    ``ssm_groups``) and what those heads read and write -- the z, x and dt
    columns of ``w_in``, the x channels of ``conv_w`` / ``conv_b``,
    ``norm_w``, the rows of ``w_out``, the heads of ``a_log`` / ``dt_bias``
    / ``d_skip`` -- with the B and C columns and conv channels of the
    groups the heads read (every group's, the whole of them, while tp does
    not divide the groups).  The order of each concatenated dim stays
    ``[z | x | B | C | dt]`` of ``w_in`` and ``[x | B | C]`` of the conv,
    so the mixer reads its local widths off the weights.  GSPMD's
    ``ssm_inner`` would hand a rank a contiguous block of those dims
    instead; this cut is the one whose rank computes whole heads.  Where
    tp does not divide the heads, everything stays whole."""
    cuts = _ssm_cuts(cfg, p, tp, index)
    return {name: cuts[name].take(t) for name, t in p.items()}


def split_cuts(cfg, axes: dict, shapes: dict, tp: int, index: int) -> dict:
    """Tp rank ``index``'s :class:`Cut` of every leaf of a model's weights
    (their logical ``axes`` and ``shapes`` trees) under ``tp_only``: each
    ``q_heads`` / ``kv_heads`` dim (flat ``H * hd`` columns) to the rank's
    whole heads (:func:`head_shard`), ``mlp`` to its column block,
    ``experts`` to its block of experts where tp divides them (the
    ``mlp`` dim of those tensors then stays whole, as :func:`spec_for`
    assigns "model" once), ``vocab`` to its row or column block, a Mamba2
    mixer (``mamba``) to its SSM heads (:func:`ssm_shard`); the router
    stays whole (top-k needs every expert's score), as do ``embed``, the
    norms and every dim tp does not divide.  A whole leaf of a split
    attention or MoE table is ``summed`` (its region's)."""
    heads = head_shard(cfg.n_heads, cfg.n_kv_heads, tp, index)
    hd = cfg.hd

    def cut(name, ax, size):
        if ax in ("q_heads", "kv_heads"):
            if heads is None:
                return None
            lo, hi = heads[:2] if ax == "q_heads" else heads[2:]
            return lo * hd, hi * hd
        if ax == "experts" and name == "router":
            return None
        if ax in ("mlp", "experts", "vocab"):
            return _block(size, tp, index)
        return None

    def leaf(name, ax, shape):
        for i, a in enumerate(ax):
            span = cut(name, a, shape[i])
            if span is not None:
                return Cut(i, *span)
        return WHOLE

    def region(table: dict) -> dict:
        """Mark the whole leaves of a split region's table."""
        def split(t):
            return t.dim is not None
        marks = {}
        if "wq" in table and split(table["wq"]):
            marks = {k: True for k in ("q_norm", "k_norm")}
        if "router" in table:
            marks = {"router": split(table["w_down"]),
                     "shared_gate": "shared" in table
                     and split(table["shared"]["w_down"])}
        return {k: dataclasses.replace(v, summed=True)
                if marks.get(k) and v.dim is None else v
                for k, v in table.items()}

    def walk(ax_tree, shape_tree):
        out = {k: _ssm_cuts(cfg, shape_tree[k], tp, index) if k == "mamba"
               else walk(ax_tree[k], shape_tree[k])
               if isinstance(shape_tree[k], dict)
               else leaf(k, ax_tree[k], tuple(shape_tree[k].shape))
               for k in shape_tree}
        return region(out)
    return walk(axes, shapes)


def tp_shard_params(cfg, params: dict, axes: dict, tp: int,
                    index: int) -> dict:
    """Tp rank ``index``'s shards of a model's ``params`` (nested dicts of
    tensors, with their logical ``axes`` tree) under ``tp_only``: each
    leaf cut as :func:`split_cuts` says (whole heads, MLP columns, experts
    or their columns, Mamba2 heads, the vocab block; the router, the
    norms and every dim tp does not divide whole).  Decoders and enc-dec
    alike (its encoder, self- and cross-attention split their heads as a
    decoder's).  Returns new contiguous tensors where a leaf is cut (the
    whole ones can be freed)."""
    cuts = split_cuts(cfg, axes, params, tp, index)

    def walk(tree, cut_tree):
        return {k: walk(v, cut_tree[k]) if isinstance(v, dict)
                else cut_tree[k].take(v) for k, v in tree.items()}
    return walk(params, cuts)
