"""Qwen3-0.6B [hf:Qwen/Qwen3-0.6B family; hf].

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936; qk_norm, GQA,
head_dim 128 (decoupled from d_model), tied embeddings.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=3072, vocab_size=151936,
    qk_norm=True, rope_theta=1e6, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen3-0.6b-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab_size=512, qk_norm=True, tie_embeddings=True,
    param_dtype="float32", compute_dtype="float32",
)
