"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B; hf].

24L d_model=2048 16H (kv=16, MHA) per-expert d_ff=1408 vocab=151936;
60 routed experts top-4 plus 4 shared experts (shared intermediate
4 x 1408 = 5632), QKV bias.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, d_expert=1408, vocab_size=151936,
    n_experts=60, n_experts_active=4, n_shared_experts=4,
    qkv_bias=True, rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="qwen2-moe-a2.7b-smoke", family="moe",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=64, d_expert=64, vocab_size=512,
    n_experts=8, n_experts_active=4, n_shared_experts=2, qkv_bias=True,
    param_dtype="float32", compute_dtype="float32",
)
