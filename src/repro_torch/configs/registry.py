"""Architecture registry: ``--arch <id>`` resolution for the port's launchers.

Lists only the archs the port serves; the reference registry's other archs
wait for their model families (ROADMAP Queue 1)."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

#: arch id -> module name (one file per served architecture)
ARCHS = {
    "qwen3-0.6b": "qwen3_0_6b",
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
