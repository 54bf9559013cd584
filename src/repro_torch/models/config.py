"""Model configuration: one dataclass covering all 10 assigned families."""
from __future__ import annotations

import dataclasses
from typing import Literal


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "hybrid", "ssm", "encdec", "vlm", "audio"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None          # default d_model // n_heads

    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    window: int | None = None            # sliding-window size (SWA)
    rope_theta: float = 1e4
    mrope_sections: tuple[int, ...] | None = None   # qwen2-vl M-RoPE (stub: 1D)

    # MoE
    n_experts: int = 0
    n_experts_active: int = 0
    n_shared_experts: int = 0
    d_expert: int = 0                    # per-expert hidden dim (0 -> d_ff)
    moe_period: int = 1                  # MoE every k-th layer (jamba: 2)
    moe_offset: int = 0                  # first MoE layer index within period

    # hybrid (jamba): one attention layer per ``attn_period`` layers
    attn_period: int = 0                 # 0 -> all layers are attention
    attn_offset: int = 0

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_expand: int = 2

    # encoder-decoder
    n_encoder_layers: int = 0

    # embeddings / frontend
    tie_embeddings: bool = False
    frontend: str | None = None          # "vision_stub" | "audio_stub"

    # numerics
    rms_eps: float = 1e-6
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # implementation switches
    attn_impl: str = "chunked"           # "ref" | "chunked" | "chunked_unrolled" | "pallas"
    #: Unroll the layer/chunk loops instead of lax.scan.  Used by the
    #: dry-run cost probes: XLA's cost analysis does not multiply while-loop
    #: bodies by trip count, so roofline FLOPs/bytes/collectives are read
    #: from shallow UNROLLED variants and extrapolated linearly in depth.
    unroll_layers: bool = False
    #: When unroll_layers is set, also unroll the SSD chunk loop.  Disabled
    #: for hybrid (jamba) probes: 256 chunks x 14 layers is a multi-hour
    #: compile while SSD is <0.5% of the cell's FLOPs (documented in
    #: EXPERIMENTS.md SRoofline).
    ssd_probe_unroll: bool = True
    attn_chunk_q: int = 1024
    attn_chunk_k: int = 1024
    moe_capacity_factor: float = 1.25
    moe_dispatch: str = "scatter"        # "scatter" | "sort" (gather-only)
    ssd_chunk: int = 128
    remat: str = "block"                 # "none" | "block" | "dots" | "full"
    #: "batch"  -- [B, Hkv, S, hd] per layer (batch-sharded);
    #: "paged"  -- EMem page store via the BlockManager's *reserved* policy
    #:             (each slot statically owns its worst-case max_pages);
    #: "pooled" -- EMem page store via the BlockManager's *on-demand*
    #:             policy: frames allocated from a shared pool as sequences
    #:             grow, with prefix sharing / copy-on-write and preemptive
    #:             admission (decouples the decode batch width from the KV
    #:             memory reservation).
    kv_layout: str = "batch"
    #: Paged-decode impl for the paged/pooled layouts (and the batch layout's
    #: pooled-store callers): "auto" -- fused VM-walking Pallas kernels on
    #: TPU, composed jnp ops elsewhere; "fused" -- force the Pallas path
    #: (interpret mode off-TPU); "composed" -- force the reference ops.
    #: Fused needs whole KV-head groups per tensor-parallel shard; the
    #: dispatch layer falls back to "composed" otherwise.
    paged_kernel: str = "auto"
    kv_dtype: str | None = None          # KV cache dtype override (e.g.
                                         # "float8_e4m3fn" -- halves KV traffic)
    kv_page_slots: int = 256
    #: Total frames in the pooled KV store (kv_layout="pooled"); None sizes
    #: the pool like the fixed layout (batch * ceil(max_len / page_slots)).
    kv_pool_pages: int | None = None
    logical_rules: str = "fsdp_tp"       # parallel/sharding.py rule set
    #: Constrain INNER activations (q/k/v, MLP hidden) to batch-sharded,
    #: head/ff-model-sharded layouts.  Without this GSPMD may contract over
    #: the FSDP-sharded d_model dim of the weights and all-reduce full-batch
    #: partial activations (observed: 2.15 GB psums vs the 64 MB weight
    #: all-gather it should emit).  §Perf cell C lever.
    constrain_inner: bool = False
    #: optimization_barrier at block boundaries: stops XLA hoisting the
    #: f32 convert (for the next norm) ABOVE the TP all-reduce, halving
    #: collective bytes.  §Perf cell C lever.
    block_barrier: bool = False

    # -- derived ---------------------------------------------------------------
    def __post_init__(self):
        assert self.n_heads % max(1, self.n_kv_heads) == 0

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def vocab_padded(self) -> int:
        return round_up(self.vocab_size, 128)

    @property
    def d_inner(self) -> int:            # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def layer_period(self) -> int:
        """Length of the repeating layer pattern (for scan-over-layers)."""
        p = max(1, self.moe_period)
        if self.attn_period:
            p = max(p, self.attn_period)
        assert self.n_layers % p == 0, (self.n_layers, p)
        return p

    @property
    def n_periods(self) -> int:
        return self.n_layers // self.layer_period

    def layer_kind(self, idx_in_period: int) -> str:
        """'attn' or 'mamba' for position ``idx_in_period`` of the pattern."""
        if self.family == "ssm":
            return "mamba"
        if self.attn_period:
            return ("attn" if idx_in_period % self.attn_period == self.attn_offset
                    else "mamba")
        return "attn"

    def layer_has_moe(self, idx_in_period: int) -> bool:
        if self.n_experts == 0:
            return False
        return idx_in_period % self.moe_period == self.moe_offset

    def layer_has_mlp(self, idx_in_period: int) -> bool:
        # pure-SSM blocks (mamba2) have no separate MLP
        return self.family != "ssm"

    # -- parameter counts (for roofline MODEL_FLOPS) ---------------------------
    def param_count(self, active_only: bool = False) -> int:
        """Total (or active-per-token) parameter count, embeddings included."""
        d, hd = self.d_model, self.hd
        emb = self.vocab_padded * d * (1 if self.tie_embeddings else 2)
        total = emb
        n_dec = self.n_layers
        for i in range(self.layer_period):
            per = self._layer_params(i, active_only)
            total += per * self.n_periods
        if self.n_encoder_layers:
            attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
                + (self.n_heads * hd) * d
            mlp = 3 * d * self.d_ff
            total += self.n_encoder_layers * (attn + mlp)
            # decoder cross-attention
            total += n_dec * attn
        return total

    def _layer_params(self, i: int, active_only: bool) -> int:
        d, hd = self.d_model, self.hd
        n = 0
        if self.layer_kind(i) == "attn":
            n += d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd)
            n += (self.n_heads * hd) * d
        else:
            din, hs = self.d_inner, self.ssm_heads
            n += d * (2 * din + 2 * self.ssm_groups * self.ssm_state + hs)
            n += self.ssm_conv * din + din * d + 2 * hs
        if self.layer_has_mlp(i):
            if self.layer_has_moe(i):
                de = self.d_expert or self.d_ff
                n_routed = (self.n_experts_active if active_only
                            else self.n_experts)
                n += n_routed * 3 * d * de
                if self.n_shared_experts:
                    n += 3 * d * (self.n_shared_experts * de)
                n += d * self.n_experts    # router
            else:
                n += 3 * d * self.d_ff
        return n
