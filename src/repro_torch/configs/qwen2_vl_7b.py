"""Qwen2-VL-7B backbone [arXiv:2409.12191; hf].

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064; M-RoPE, dynamic
resolution.  The vision frontend is a stub: train/prefill inputs are
precomputed patch embeddings; M-RoPE degenerates to 1-D RoPE for the
text-shaped assigned inputs (DESIGN.md §4).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, head_dim=128,
    d_ff=18944, vocab_size=152064,
    qkv_bias=True, rope_theta=1e6, mrope_sections=(16, 24, 24),
    frontend="vision_stub",
)

SMOKE = ModelConfig(
    name="qwen2-vl-7b-smoke", family="vlm",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab_size=512,
    qkv_bias=True, rope_theta=1e6, mrope_sections=(8, 12, 12),
    frontend="vision_stub",
    param_dtype="float32", compute_dtype="float32",
)
