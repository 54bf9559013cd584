"""Mixtral-8x7B [arXiv:2401.04088; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000; 8 experts top-2 on
every layer, sliding-window attention (4096).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000,
    n_experts=8, n_experts_active=2, window=4096, rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="mixtral-8x7b-smoke", family="moe",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab_size=512,
    n_experts=4, n_experts_active=2, window=8,
    param_dtype="float32", compute_dtype="float32",
)
