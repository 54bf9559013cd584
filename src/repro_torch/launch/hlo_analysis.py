"""Cost counting and roofline terms for the dry-run (a port of
``repro.launch.hlo_analysis``; the name is kept so a reader finds the
counterpart).

The reference reads XLA's compiled HLO: ``cost_analysis()`` for FLOPs and
bytes accessed, the optimized HLO text for collective traffic
(``parse_collectives``) and ``memory_analysis()`` for the working set
(``memory_of``).  No HLO exists here: the port runs eagerly, and the
dry-run runs one rank's step on ``meta`` tensors.  In its place
:class:`CostCounter`, a ``TorchDispatchMode``, sees every aten op the step
dispatches and counts, for that rank:

  * FLOPs, by ``torch.utils.flop_counter.FlopCounterMode``'s formulas (the
    matmuls, convolutions and attention ops; elementwise ops count 0, as
    they do in FlopCounterMode);
  * bytes accessed: the input and output bytes of every op, views 0, an
    output that is one of the op's inputs (an in-place op) once.  Nothing
    is fused in an eager step, so this is the unfused upper bound, as
    XLA-CPU's "bytes accessed" was;
  * peak live bytes: the tensors the caller names as resident, plus every
    storage an op allocates, from its allocation until it is freed;
  * collectives by op and count in :data:`COLLECTIVE_OPS`' keys, each at
    the bytes of its result (the reference's per-device proxy): the
    ``_c10d_functional`` ops (DTensor's redistribute and ``full_tensor``)
    and the ``c10d`` ops (``torch.distributed``'s calls, as
    ``mesh_ctx.all_reduce`` makes them).

DTensor ops are counted once, at the local ops each rank runs: the counter
lets DTensor's own dispatch run and sees the ops it issues on the local
shards; the fake tensors of its sharding propagation are not counted
(``torch.distributed.tensor.debug.CommDebugMode`` is the model).

Without a counterpart: ``parse_collectives`` and ``memory_of`` (there is no
HLO text or compiled executable), XLA's ``generated_code_size_in_bytes``
and ``alias_size_in_bytes`` (no code is generated, and no buffer is
donated), and post-fusion bytes (no op is fused).

Roofline terms, H100 SXM5 80GB at 700 W (NVIDIA's data sheet, dense
rates; the same values as PERF.md §2):
    compute    = FLOPs      / 989e12 FLOP/s (bf16 tensor cores)
    memory     = bytes      / 3.35e12 B/s (HBM3)
    collective = coll_bytes / link rate: NVLink 4, 450e9 B/s per direction
                 per GPU, within one 8-GPU node; one 400 Gb/s NIC per GPU,
                 50e9 B/s, for an axis that spans nodes, as every axis of
                 the 16x16 and 2x16x16 meshes does.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# -- hardware constants (H100 SXM5 80GB, 700 W) ------------------------------
PEAK_FLOPS_BF16 = 989e12          # per GPU, dense
HBM_BW = 3.35e12                  # bytes/s per GPU
NVLINK_BW = 450e9                 # bytes/s per direction per GPU (NVLink 4)
NIC_BW = 50e9                     # bytes/s: one 400 Gb/s NIC per GPU
GPUS_PER_NODE = 8
DEVICE_BYTES = 80e9               # HBM3 capacity

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute", "ragged-all-to-all")

#: the collective ops of torch's two namespaces -> the reference's keys
#: (another one is counted under its own name).  ``_c10d_functional`` ops
#: return their result; the ``c10d`` ops write it into their first
#: argument.
_FUNCTIONAL = {
    "all_gather_into_tensor": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_C10D = {
    "allreduce_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}
#: ops of those namespaces that move nothing
_NOT_COLLECTIVES = ("wait_tensor", "_wrap_tensor_autograd")


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_op: dict
    count_by_op: dict

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_op.values())


def _tensors(x) -> list:
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _resident_bytes(*trees) -> int:
    """Bytes of the distinct storages under ``trees`` (nested dicts, lists
    or tuples of tensors; a DTensor counts its local shard)."""
    from torch.distributed.tensor import DTensor
    seen: dict[int, int] = {}
    for t in _tensors(trees):
        if isinstance(t, DTensor):
            t = t.to_local()
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


class CostCounter(TorchDispatchMode):
    """One rank's cost of what runs inside ``with CostCounter(...) as c:``
    (see the module docstring): ``c.flops``, ``c.bytes_accessed``,
    ``c.peak_bytes`` (``resident``'s bytes plus the most the step held at
    once of what it allocated), ``c.collectives`` and ``c.ops``."""

    def __init__(self, resident=()):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode
        self._flop_counter = FlopCounterMode(display=False)
        self.resident_bytes = _resident_bytes(resident)
        self.flops = 0
        self.bytes_accessed = 0
        self.ops = 0
        self.live_bytes = self.peak_live_bytes = 0
        self._live: dict[int, int] = {}
        self.collectives = CollectiveStats({k: 0 for k in COLLECTIVE_OPS},
                                           {k: 0 for k in COLLECTIVE_OPS})

    @property
    def peak_bytes(self) -> int:
        return self.resident_bytes + self.peak_live_bytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # counted at its local ops
        out = func(*args, **kwargs)
        if torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None:
            return out                     # DTensor's sharding propagation
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        self.ops += 1
        ns = func.namespace
        if ns in ("_c10d_functional", "c10d"):
            self._collective(func, args, out)
        self.flops += self._flops_of(func, args, kwargs, out)
        if func.is_view:
            return
        ins = _tensors((args, kwargs))
        in_keys = {_storage_key(t) for t in ins}
        outs = [t for t in _tensors(out) if _storage_key(t) not in in_keys]
        self.bytes_accessed += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        for t in outs:
            self._allocated(t.untyped_storage())

    def _flops_of(self, func, args, kwargs, out) -> int:
        formula = self._flop_counter.flop_registry.get(func._overloadpacket)
        if formula is None:
            return 0
        return formula(*args, **kwargs, out_val=out)

    def _allocated(self, storage) -> None:
        key = storage._cdata
        if key in self._live:
            return
        n = storage.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
        weakref.finalize(storage, self._freed, key)

    def _freed(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key)

    def _collective(self, func, args, out) -> None:
        name = func._opname
        if name in _NOT_COLLECTIVES:
            return
        if func.namespace == "_c10d_functional":
            op, result = _FUNCTIONAL.get(name, name), out
        else:
            op, result = _C10D.get(name, name), args[0]
        stats = self.collectives
        stats.bytes_by_op[op] = stats.bytes_by_op.get(op, 0) + sum(
            map(_nbytes, _tensors(result)))
        stats.count_by_op[op] = stats.count_by_op.get(op, 0) + 1


def link_bw(n_devices: int) -> float:
    """The link rate a collective of an ``n_devices`` mesh runs at: NVLink
    within one 8-GPU node, the NIC across nodes."""
    return NVLINK_BW if n_devices <= GPUS_PER_NODE else NIC_BW


@dataclasses.dataclass
class Roofline:
    flops: float                 # PER-DEVICE counted flops
    hbm_bytes: float             # per-device bytes accessed
    coll_bytes_per_device: float
    n_devices: int

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS_BF16

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes_per_device / link_bw(self.n_devices)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self) -> dict:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes_per_device": self.coll_bytes_per_device,
            "n_devices": self.n_devices,
        }


def model_flops(param_count_active: int, tokens: int,
                train: bool) -> float:
    """MODEL_FLOPS = 6ND for training, 2ND for inference forward."""
    return (6.0 if train else 2.0) * param_count_active * tokens


def analytic_hbm_bytes(cfg, shape, *, n_dev: int, dp: int, tp: int,
                       microbatches: int = 1) -> float:
    """Analytic per-device HBM traffic model (the reference's, term for
    term).

    The counted bytes accessed count every op's operands, which in an
    unfused eager step overstates HBM traffic by the length of the
    elementwise chains; flash-style kernels keep attention intermediates
    on chip.  This model counts the traffic that MUST hit HBM: weights (x3:
    fwd, remat re-read, bwd), optimizer state, boundary activations, flash
    KV re-reads, and logits.
    """
    bs, seq, kind = shape.global_batch, shape.seq_len, shape.kind
    d, f, hd = cfg.d_model, max(cfg.d_ff, 1), cfg.hd
    hkv = cfg.n_kv_heads
    P = cfg.param_count()
    P_active = cfg.param_count(active_only=True)
    V = cfg.vocab_padded
    W = 2.0 * P_active / tp          # bf16 weights touched per device pass
    m = max(1, microbatches)

    if kind == "decode":
        tokens_loc = max(1, bs // dp)
        cache = 0.0
        if cfg.family != "ssm":
            from repro_torch.device import torch_dtype
            kv_bytes = torch_dtype(cfg.kv_dtype
                                   or cfg.compute_dtype).itemsize
            n_attn = (cfg.n_layers // cfg.attn_period if cfg.attn_period
                      else cfg.n_layers)
            # paged KV is sharded over the DP axes only (model-replicated)
            kv_shards = dp if cfg.kv_layout == "paged" else n_dev
            cache = 2.0 * n_attn * bs * seq * hkv * hd * kv_bytes / kv_shards
        act = cfg.n_layers * tokens_loc * 8 * d * 2
        logits = tokens_loc * V / tp * 4
        return 2.0 * P / tp / max(1, dp if cfg.logical_rules == "fsdp_tp"
                                  else 1) + W + cache + act + logits

    tokens_loc = bs * seq // dp
    act_width = 4 * d + 3 * f / tp + 2 * cfg.n_heads * hd / tp
    fwd_bwd = 3.0 if kind == "train" else 1.0   # fwd + remat-fwd + bwd
    act = cfg.n_layers * (tokens_loc / m) * act_width * 2 * fwd_bwd * m
    # flash attention KV re-reads: K,V streamed once per 512-row query block
    n_attn = (cfg.n_layers // cfg.attn_period if cfg.attn_period
              else (0 if cfg.family == "ssm" else cfg.n_layers))
    kv_reread = (n_attn * tokens_loc * hkv * hd * 2 * 2
                 * max(1, min(seq, cfg.window or seq) / 512) / tp)
    logits = tokens_loc * V / tp * 4 * (3 if kind == "train" else 1)
    weights = fwd_bwd * m * W
    opt = (P * 20.0 / n_dev) if kind == "train" else 0.0
    return weights + opt + act + kv_reread + logits
