"""K4: the hand-written CUDA flash-decode kernel -- build, binding,
wrapper.

``csrc/flash_decode.cu`` holds the kernel (its header comment gives the
design and the bound).  :func:`flash_decode` launches it on the current
stream, building the library with ``nvcc`` at first use
(:mod:`repro_torch.kernels.build`), and adds one to
``LAUNCHES["flash_decode"]``; any failure raises, and so do CPU tensors: a
CUDA kernel has no interpret mode.  Its plain version is the non-kernel
branch of :func:`repro_torch.kernels.paged_decode.flash_ops.decode_attention_partial`,
which agrees with the kernel on empty rows too.
"""
from __future__ import annotations

from pathlib import Path

import torch

from repro_torch.kernels import build as _build

#: launches since the last :func:`reset_launch_counts`
LAUNCHES = {"flash_decode": 0}

SOURCES = (Path(__file__).resolve().parent / "csrc" / "flash_decode.cu",)
LIBRARY = "flash_decode"


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build() -> tuple[Path, str]:
    """Build this library (see :func:`repro_torch.kernels.build.build`)."""
    return _build.build(LIBRARY, SOURCES)


def _bind(lib) -> None:
    import ctypes
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_decode.argtypes = [p] * 7 + [i] * 6 + [f, i, i, p]
    lib.flash_decode.restype = i


def flash_decode(q, k, v, lengths, *, scale: float | None = None,
                 window: int | None = None):
    """q: [B, Hkv, G, D]; k, v: [B, Hkv, S, D]; lengths: int32 [B] (all
    contiguous CUDA tensors).  Returns (out [B, Hkv, G, D] in q's dtype,
    normalised by the local l; m [B, Hkv, G, 1] f32; l [B, Hkv, G, 1]
    f32)."""
    dev = _build.check_cuda(q=q, k=k, v=v, lengths=lengths)
    b, hkv, g, d = q.shape
    if k.dim() != 4 or tuple(k.shape[:2]) != (b, hkv) or k.shape[3] != d \
            or v.shape != k.shape or v.dtype != k.dtype:
        raise ValueError(f"k, v must be [{b}, {hkv}, S, {d}] and match, got "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (b,):
        raise ValueError(f"lengths must be int32 [{b}], got "
                         f"{lengths.dtype} {tuple(lengths.shape)}")
    q_code = _build.dtype_code(q, "q")
    kv_code = _build.dtype_code(k, "k")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    scale = d ** -0.5 if scale is None else float(scale)
    out = torch.empty_like(q)
    m = torch.empty((b, hkv, g, 1), dtype=torch.float32, device=dev)
    l = torch.empty((b, hkv, g, 1), dtype=torch.float32, device=dev)
    lib = _build.load(LIBRARY, SOURCES, _bind)
    with torch.cuda.device(dev):
        err = lib.flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), m.data_ptr(), l.data_ptr(), b, hkv, g,
            k.shape[2], d, 0 if window is None else int(window), scale,
            q_code, kv_code, _build.stream_of(dev))
    if err == _build.CUDA_ERROR_INVALID_VALUE:
        raise ValueError(
            f"flash_decode refused D={d}, G={g} (CUDA error {err}): the "
            "kernel takes even head dims 2..256, groups whose per-warp "
            "softmax records fit 48 KB of shared memory and pointers "
            "aligned to an element pair (csrc/flash_decode.cu)")
    if err:
        raise RuntimeError(f"flash_decode launch failed: CUDA error {err}")
    LAUNCHES["flash_decode"] += 1
    return out, m, l
