"""K5: the hand-written CUDA SSD-scan kernel -- build, binding, wrapper.

``csrc/ssd.cu`` holds the kernel (its header comment gives the design and
the bound).  :func:`ssd` launches it on the current stream, building the
library with ``nvcc`` at first use (:mod:`repro_torch.kernels.build`), and
adds one to ``LAUNCHES["ssd"]``; any failure raises, and so do CPU
tensors: a CUDA kernel has no interpret mode.  Its plain version is
:func:`repro_torch.kernels.mamba2_ssd.ref.ssd_chunked`.
"""
from __future__ import annotations

from pathlib import Path

import torch

from repro_torch.kernels import build as _build

#: launches since the last :func:`reset_launch_counts`
LAUNCHES = {"ssd": 0}

SOURCES = (Path(__file__).resolve().parent / "csrc" / "ssd.cu",)
LIBRARY = "mamba2_ssd"


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build() -> tuple[Path, str]:
    """Build this library (see :func:`repro_torch.kernels.build.build`)."""
    return _build.build(LIBRARY, SOURCES)


def _bind(lib) -> None:
    import ctypes
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssd.argtypes = [p] * 8 + [i] * 8 + [p]
    lib.ssd.restype = i


def ssd(x, dt, A, B, C, D, *, chunk: int):
    """x: [Bt, S, H, P]; dt: [Bt, S, H] f32; A, D: [H] f32; B, C:
    [Bt, S, G, N] in x's dtype (H % G == 0); contiguous CUDA tensors.
    Returns (y [Bt, S, H, P] in x's dtype, final state [Bt, H, N, P] f32)."""
    dev = _build.check_cuda(x=x, dt=dt, A=A, B=B, C=C, D=D)
    if x.dim() != 4 or B.dim() != 4 or B.shape != C.shape:
        raise ValueError(f"x must be [Bt, S, H, P] and B, C [Bt, S, G, N], "
                         f"got {tuple(x.shape)} / {tuple(B.shape)} / "
                         f"{tuple(C.shape)}")
    bt, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if (tuple(B.shape[:2]) != (bt, s) or tuple(dt.shape) != (bt, s, h)
            or tuple(A.shape) != (h,) or tuple(D.shape) != (h,)
            or g < 1 or h % g):
        raise ValueError(f"shapes do not fit: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, D "
                         f"{tuple(D.shape)}, B/C {tuple(B.shape)}")
    if B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"x, B, C must share a dtype, got {x.dtype}, "
                         f"{B.dtype}, {C.dtype}")
    for name, t in (("dt", dt), ("A", A), ("D", D)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    code = _build.dtype_code(x, "x")
    y = torch.empty_like(x)
    state = torch.empty((bt, h, n, p), dtype=torch.float32, device=dev)
    lib = _build.load(LIBRARY, SOURCES, _bind)
    with torch.cuda.device(dev):
        err = lib.ssd(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                      C.data_ptr(), D.data_ptr(), y.data_ptr(),
                      state.data_ptr(), bt, s, h, p, g, n, int(chunk), code,
                      _build.stream_of(dev))
    if err == _build.CUDA_ERROR_INVALID_VALUE:
        raise ValueError(
            f"ssd refused P={p}, N={n}, H={h}, G={g}, chunk={chunk} (CUDA "
            f"error {err}): the kernel takes P and N that are multiples of "
            "4 up to 64 and 128, chunks of 1 to 128 and pointers aligned to "
            "4 elements (csrc/ssd.cu)")
    if err:
        raise RuntimeError(f"ssd launch failed: CUDA error {err}")
    LAUNCHES["ssd"] += 1
    return y, state
