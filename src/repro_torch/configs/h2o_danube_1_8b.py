"""H2O-Danube-1.8B [arXiv:2401.16818; hf].

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000; llama+mistral mix
with sliding-window attention (window 4096).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8, head_dim=80,
    d_ff=6912, vocab_size=32000,
    window=4096, rope_theta=1e4,
)

SMOKE = ModelConfig(
    name="h2o-danube-1.8b-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab_size=512, window=8, rope_theta=1e4,
    param_dtype="float32", compute_dtype="float32",
)
