"""Architecture registry: ``--arch <id>`` resolution for the port's launchers.

The reference registry's ten archs: dense, MoE, the MoE + Mamba2 hybrid,
the Mamba2 SSM, the VLM backbone fed frame embeddings (qwen2-vl-7b) and
the encoder-decoder (seamless-m4t-medium)."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

#: arch id -> module name (one file per served architecture)
ARCHS = {
    "qwen2-vl-7b": "qwen2_vl_7b",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "qwen3-0.6b": "qwen3_0_6b",
    "granite-3-2b": "granite_3_2b",
    "qwen2-72b": "qwen2_72b",
    "mixtral-8x7b": "mixtral_8x7b",
    "qwen2-moe-a2.7b": "qwen2_moe_a27b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "mamba2-780m": "mamba2_780m",
}


def _module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def list_archs() -> list[str]:
    return list(ARCHS)
