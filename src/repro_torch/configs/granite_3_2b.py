"""Granite-3.0-2B base [hf:ibm-granite/granite-3.0-2b-base; hf].

40L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=49155.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b", family="dense",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
    d_ff=8192, vocab_size=49155,
    rope_theta=1e4, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="granite-3-2b-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab_size=515, tie_embeddings=True,
    param_dtype="float32", compute_dtype="float32",
)
