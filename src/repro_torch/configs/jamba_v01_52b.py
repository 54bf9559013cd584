"""Jamba-v0.1 (52B MoE hybrid) [arXiv:2403.19887; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536; Mamba+attention at a
1:7 interleave (1 attention layer per 8), MoE 16 experts top-2 on every
second layer.  Jamba-v0.1 uses Mamba-1 mixers (d_state=16); the reference
implements the mixer with the Mamba-2 SSD formulation at the same state size
(SSD's chunked matmuls map to matrix units, Mamba-1's diagonal scan does
not), and the port keeps it, so its prefill runs the SSD scan at N 16.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=65536,
    n_experts=16, n_experts_active=2, moe_period=2, moe_offset=1,
    attn_period=8, attn_offset=0,
    ssm_state=16, ssm_head_dim=64, ssm_groups=1, ssm_conv=4, ssm_expand=2,
)

SMOKE = ModelConfig(
    name="jamba-v0.1-52b-smoke", family="hybrid",
    n_layers=8, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab_size=512,
    n_experts=4, n_experts_active=2, moe_period=2, moe_offset=1,
    attn_period=8, attn_offset=0,
    ssm_state=8, ssm_head_dim=32, ssm_groups=1, ssm_conv=4, ssm_expand=2,
    param_dtype="float32", compute_dtype="float32", ssd_chunk=8,
)
