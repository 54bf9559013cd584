"""Mixture-of-Experts MLP with capacity-based dispatch (a port of
``repro.models.moe``).

Top-k routing with a fixed per-expert capacity: a (token, choice) pair past
its expert's capacity is dropped.  Every row of the block's input counts
towards the capacity and takes its expert's slots in ``[T * k]`` order,
token-major, so rows couple: which pairs drop depends on the other rows of
the batch (in the serving engine, idle slots and the masked-off rows of a
token-by-token prefill too).  This is the reference's semantics, kept
exactly.  Two dispatches build the same ``[E, C, d]`` expert buffers:
``scatter`` (positions by a cumsum in token-major order) and ``sort``
(positions by a stable argsort).  Every expert's product runs over its
whole buffer, empty slots included, as in the reference: a decode step
reads every expert's weights.

Ties: ``jax.lax.top_k`` takes the lowest index first among equal values.
``torch.topk`` promises no order among ties (on the CPU or on CUDA), so
the port selects by a stable descending sort, which does.

Shared experts (qwen2-moe) always run, dense, behind a sigmoid gate.  The
router's softmax and top-k run in f32, as in the reference.

A tensor-parallel rank's split form (``tp_only``) keeps the router whole,
so every rank routes, fills capacity and breaks ties exactly as one device
does; it holds its block of the experts where tp divides them, else its
``mlp`` columns of every expert, and its columns of the shared expert.  It
computes the buffers of the experts it holds (or its columns of all of
them), combines its partial output and sums it over the tp group in one
call; a piece the rank holds whole is added after that sum.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (ParamDef, mlp_defs, row_parallel_sum,
                                       swiglu)
from repro_torch.parallel import mesh_ctx


def moe_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    e = cfg.n_experts
    de = cfg.d_expert or cfg.d_ff
    defs = {
        "router": ParamDef((d, e), ("embed", "experts")),
        "w_gate": ParamDef((e, d, de), ("experts", "embed", "mlp")),
        "w_up": ParamDef((e, d, de), ("experts", "embed", "mlp")),
        "w_down": ParamDef((e, de, d), ("experts", "mlp", "embed")),
    }
    if cfg.n_shared_experts:
        defs["shared"] = mlp_defs(cfg, d_ff=cfg.n_shared_experts * de)
        defs["shared_gate"] = ParamDef((d, 1), ("embed", None))
    return defs


def moe_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    cap = int(math.ceil(n_tokens * cfg.n_experts_active / cfg.n_experts
                        * cfg.moe_capacity_factor))
    return max(1, min(cap, n_tokens))


def moe_block(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """x: [B, S, d] -> [B, S, d].  Dispatch selected by cfg.moe_dispatch."""
    if cfg.moe_dispatch == "sort":
        return moe_block_sorted(cfg, p, x)
    return moe_block_scatter(cfg, p, x)


def _route(cfg: ModelConfig, p, xt: torch.Tensor):
    """Router probabilities [T, E] in f32, and the top-k choices: weights
    [T, k] renormalised and expert ids [T, k], ties lowest index first."""
    probs = torch.softmax((xt @ p["router"]).float(), dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, idx = top[:, :cfg.n_experts_active], idx[:, :cfg.n_experts_active]
    return probs, weights / weights.sum(-1, keepdim=True), idx


def _first_expert(cfg: ModelConfig, p) -> int:
    """The first expert the tables ``p`` hold: 0, or a tensor-parallel
    rank's block of the experts."""
    e_loc = p["w_gate"].shape[0]
    return mesh_ctx.tp_index() * e_loc if e_loc < cfg.n_experts else 0


def _experts(cfg: ModelConfig, p, buf: torch.Tensor) -> torch.Tensor:
    """The SwiGLU of each expert ``p`` holds over its buffer: [E, C, d] ->
    [E_loc, C, d]."""
    if buf.shape[0] != p["w_gate"].shape[0]:
        e_lo = _first_expert(cfg, p)
        buf = buf[e_lo:e_lo + p["w_gate"].shape[0]]
    h = F.silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    return torch.bmm(h, p["w_down"])


def _combine(cfg: ModelConfig, p, xt, out_buf, flat_e, pos, keep, weights):
    """Gather each kept (token, choice) row of ``out_buf`` (dropped pairs
    and the experts ``p`` does not hold read row 0 and are zeroed), weight,
    sum over the choices, add the shared experts: [T, d].  Where ``p``
    holds a tensor-parallel rank's experts or columns, the partials are
    summed over the tp group in one call (:func:`row_parallel_sum`)."""
    t, d = xt.shape
    e_loc, de_loc = p["w_down"].shape[:2]
    if e_loc < cfg.n_experts:
        e_lo = _first_expert(cfg, p)
        keep = keep & (flat_e >= e_lo) & (flat_e < e_lo + e_loc)
        flat_e = flat_e - e_lo
    gathered = out_buf[torch.where(keep, flat_e, 0), torch.where(keep, pos, 0)]
    gathered = torch.where(keep[:, None], gathered, 0)
    y = (gathered.reshape(t, cfg.n_experts_active, d)
         * weights[..., None].to(xt.dtype)).sum(dim=1)
    de = cfg.d_expert or cfg.d_ff
    parts = [(y, e_loc * de_loc, cfg.n_experts * de)]
    if cfg.n_shared_experts:
        parts.append((_shared(p, xt), p["shared"]["w_down"].shape[0],
                      cfg.n_shared_experts * de))
    return row_parallel_sum(parts)


def _shared(p, xt):
    """The shared experts' gated SwiGLU over the columns ``p`` holds."""
    gate = torch.sigmoid((xt @ p["shared_gate"]).float())
    return swiglu(p["shared"], xt) * gate.to(xt.dtype)


def _scatter_positions(flat_e: torch.Tensor, e: int) -> torch.Tensor:
    """Position of each (token, choice) of ``flat_e`` [T*k] within its
    expert's buffer: the count of earlier pairs with the same expert, by a
    cumsum of the one-hot choices in token-major order."""
    onehot = flat_e[:, None] == torch.arange(e, device=flat_e.device)[None, :]
    pos = torch.cumsum(onehot.to(torch.int32), dim=0) - 1
    return pos.gather(1, flat_e[:, None])[:, 0]


def _sorted_positions(flat_e: torch.Tensor, e: int):
    """The same positions by a stable argsort of ``flat_e``; also the sort
    order, each expert's first sorted element and its count."""
    onehot = flat_e[:, None] == torch.arange(e, device=flat_e.device)[None, :]
    counts = onehot.sum(0)                                     # [E]
    starts = torch.cumsum(counts, 0) - counts                  # exclusive
    order = torch.argsort(flat_e, stable=True)                 # by expert
    ar = torch.arange(flat_e.shape[0], device=flat_e.device)
    pos_sorted = ar - starts[flat_e[order]]
    inv = torch.empty_like(order)
    inv[order] = ar                                            # inverse perm
    return pos_sorted[inv], order, starts, counts


def moe_block_scatter(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """Scatter-based dispatch (the reference's baseline)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.n_experts_active
    t = b * s
    xt = x.reshape(t, d)
    cap = moe_capacity(cfg, t)
    _, weights, idx = _route(cfg, p, xt)

    flat_e = idx.reshape(t * k)                                # [T*k]
    pos = _scatter_positions(flat_e, e)
    keep = pos < cap
    # dropped pairs go to an explicit dump row e, cut off after the scatter
    row = torch.where(keep, flat_e, e)
    col = torch.where(keep, pos, 0)
    buf = torch.zeros((e + 1, cap, d), dtype=x.dtype, device=x.device)
    buf[row, col] = xt.repeat_interleave(k, dim=0)
    out_buf = _experts(cfg, p, buf[:e])
    y = _combine(cfg, p, xt, out_buf, flat_e, pos, keep, weights)
    return y.reshape(b, s, d)


def moe_block_sorted(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """Gather-only dispatch: a stable argsort by expert and dense one-hot
    counts (the reference's ``sort``)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.n_experts_active
    t = b * s
    xt = x.reshape(t, d)
    cap = moe_capacity(cfg, t)
    _, weights, idx = _route(cfg, p, xt)

    flat_e = idx.reshape(t * k)                                # [T*k]
    pos, order, starts, counts = _sorted_positions(flat_e, e)
    keep = pos < cap
    # buffer slot (e, c) holds sorted element starts[e] + c if c < counts[e];
    # the rest read a clamped element and are zeroed
    cols = torch.arange(cap, device=x.device)
    gidx = starts[:, None] + cols[None, :]                     # [E, C]
    valid = cols[None, :] < counts[:, None]
    tok_choice = order[gidx.clamp(0, t * k - 1)]               # [E, C]
    buf = torch.where(valid[..., None], xt[tok_choice // k], 0)
    out_buf = _experts(cfg, p, buf)
    y = _combine(cfg, p, xt, out_buf, flat_e, pos, keep, weights)
    return y.reshape(b, s, d)


def moe_block_dense_oracle(cfg: ModelConfig, p, x: torch.Tensor,
                           drop: bool = False) -> torch.Tensor:
    """Every-expert-computes-every-token oracle (tests only; ``drop`` is the
    reference's, accepted and never read)."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    probs, weights, idx = _route(cfg, p, xt)
    gates = torch.zeros_like(probs).scatter(1, idx, weights)   # [T, E]
    h = torch.einsum("td,edf->tef", xt, p["w_gate"])
    h = F.silu(h) * torch.einsum("td,edf->tef", xt, p["w_up"])
    outs = torch.einsum("tef,efd->ted", h, p["w_down"])
    y = torch.einsum("ted,te->td", outs, gates.to(x.dtype))
    if cfg.n_shared_experts:
        y = y + _shared(p, xt)
    return y.reshape(b, s, d)
