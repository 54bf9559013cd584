"""K3: the hand-written CUDA flash-attention kernel -- build, binding,
wrapper.

``csrc/flash_attention.cu`` holds the kernel (its header comment gives the
design and the bound).  :func:`flash_attention` launches it on the current
stream, building the library with ``nvcc`` at first use
(:mod:`repro_torch.kernels.build`), and adds one to
``LAUNCHES["flash_attention"]``; any failure raises, and so do CPU tensors:
a CUDA kernel has no interpret mode.  Its plain version is
:func:`repro_torch.kernels.flash_attention.ref.mha`.
"""
from __future__ import annotations

from pathlib import Path

import torch

from repro_torch.kernels import build as _build

#: launches since the last :func:`reset_launch_counts`
LAUNCHES = {"flash_attention": 0}

SOURCES = (Path(__file__).resolve().parent / "csrc" / "flash_attention.cu",)
LIBRARY = "flash_attention"


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build() -> tuple[Path, str]:
    """Build this library (see :func:`repro_torch.kernels.build.build`)."""
    return _build.build(LIBRARY, SOURCES)


def _bind(lib) -> None:
    import ctypes
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention.argtypes = [p] * 4 + [i] * 8 + [f, i, p]
    lib.flash_attention.restype = i


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, scale: float | None = None):
    """q: [B, Hq, Sq, D]; k, v: [B, Hkv, Skv, D] (Hq % Hkv == 0, Sq <= Skv,
    one dtype, contiguous CUDA tensors) -> [B, Hq, Sq, D] in q's dtype."""
    dev = _build.check_cuda(q=q, k=k, v=v)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be [B, Hq, Sq, D] and k, v [B, Hkv, Skv, D], "
                         f"got {tuple(q.shape)} / {tuple(k.shape)} / "
                         f"{tuple(v.shape)}")
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hq % max(hkv, 1) or sq > skv:
        raise ValueError(f"q {tuple(q.shape)} does not fit k/v "
                         f"{tuple(k.shape)}: needs one batch and head dim, "
                         "Hq % Hkv == 0 and Sq <= Skv")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share a dtype, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    code = _build.dtype_code(q, "q")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    scale = d ** -0.5 if scale is None else float(scale)
    out = torch.empty_like(q)
    lib = _build.load(LIBRARY, SOURCES, _bind)
    with torch.cuda.device(dev):
        err = lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
            hkv, sq, skv, d, int(causal), 0 if window is None else int(window),
            scale, code, _build.stream_of(dev))
    if err == _build.CUDA_ERROR_INVALID_VALUE:
        raise ValueError(
            f"flash_attention refused D={d}, Hq={hq}, Hkv={hkv}, Sq={sq}, "
            f"Skv={skv} (CUDA error {err}): the kernel takes head dims that "
            "are multiples of 4 up to 256 and pointers aligned to 4 elements "
            "(csrc/flash_attention.cu)")
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    LAUNCHES["flash_attention"] += 1
    return out
