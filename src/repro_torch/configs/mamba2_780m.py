"""Mamba2-780M [arXiv:2405.21060; unverified].

48L d_model=1536, attention-free, vocab=50280, ssm_state=128; SSD
(state-space duality) with expand=2 (d_inner=3072), head_dim=64 -> 48 heads,
1 group.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=1, n_kv_heads=1, head_dim=64,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_head_dim=64, ssm_groups=1, ssm_conv=4, ssm_expand=2,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-780m-smoke", family="ssm",
    n_layers=2, d_model=128, n_heads=1, n_kv_heads=1, head_dim=32,
    d_ff=0, vocab_size=512,
    ssm_state=16, ssm_head_dim=32, ssm_groups=1, tie_embeddings=True,
    param_dtype="float32", compute_dtype="float32", ssd_chunk=8,
)
