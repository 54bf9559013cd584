"""SeamlessM4T-medium backbone [arXiv:2308.11596; hf].

Encoder-decoder: 12L each side, d_model=1024 16H (kv=16, MHA) d_ff=4096
vocab=256206.  The speech frontend is a stub: ``input_specs()`` provides
precomputed frame embeddings to the encoder (DESIGN.md §4).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, n_encoder_layers=12,
    d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab_size=256206,
    frontend="audio_stub", rope_theta=1e4,
)

SMOKE = ModelConfig(
    name="seamless-m4t-medium-smoke", family="encdec",
    n_layers=2, n_encoder_layers=2,
    d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=256, vocab_size=512, frontend="audio_stub",
    param_dtype="float32", compute_dtype="float32",
)
