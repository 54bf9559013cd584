"""Device selection for the port's entry points: ``cuda`` unless the caller
asks for the CPU.  There is no silent CPU fallback."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``.  A CUDA device without a usable GPU raises;
    the CPU is used only when the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev


def torch_dtype(name: str | torch.dtype) -> torch.dtype:
    """ModelConfig dtype names (``"bfloat16"``, ``"float32"``, ...) as torch
    dtypes."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt
