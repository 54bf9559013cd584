"""K5: the hand-written CUDA SSD-scan kernel -- build, binding, wrapper.

``csrc/ssd.cu`` holds the kernel in two variants (its header comment gives
the design and the bound): ``"tensor_core"``, bf16 products on the tensor
cores with f32 accumulation, and ``"cuda_core"``, f32 arithmetic on the
CUDA cores.  :func:`ssd` picks one with :func:`variant_for` before the
launch (the tensor cores for bf16 where the head dim, the state size and
the chunk are multiples of 16 up to 64, 128 and 128 and x, B and C are
aligned to 16 bytes; the CUDA cores for the rest); it never falls back on a
failure.  It launches on the current stream, building the library with
``nvcc`` at first use (:mod:`repro_torch.kernels.build`), and adds one to
``LAUNCHES["ssd"]`` and, for the tensor-core variant, to
``LAUNCHES["ssd_tc"]``; any failure raises, and so do CPU tensors: a CUDA
kernel has no interpret mode.  Its plain version is
:func:`repro_torch.kernels.mamba2_ssd.ref.ssd_chunked`.
"""
from __future__ import annotations

from pathlib import Path

import torch

from repro_torch.kernels import build as _build

#: launches since the last :func:`reset_launch_counts`: every launch, and
#: those of the tensor-core variant
LAUNCHES = {"ssd": 0, "ssd_tc": 0}

SOURCES = (Path(__file__).resolve().parent / "csrc" / "ssd.cu",)
LIBRARY = "mamba2_ssd"

#: the variants, by their code in the C entry
VARIANTS = {"cuda_core": 0, "tensor_core": 1}
#: the tensor-core variant's largest head dim, state size and chunk (each a
#: multiple of 16)
TC_MAX = {"p": 64, "n": 128, "chunk": 128}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build() -> tuple[Path, str]:
    """Build this library (see :func:`repro_torch.kernels.build.build`)."""
    return _build.build(LIBRARY, SOURCES)


def _bind(lib) -> None:
    import ctypes
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssd.argtypes = [p] * 9 + [i] * 9 + [p]
    lib.ssd.restype = i
    lib.ssd_tc_scratch_floats.argtypes = [i] * 4
    lib.ssd_tc_scratch_floats.restype = ctypes.c_longlong


def variant_for(dtype: torch.dtype, p: int, n: int, chunk: int,
                aligned: bool = True) -> str:
    """The variant :func:`ssd` launches for ``dtype``, head dim ``p``, state
    size ``n`` and ``chunk``; ``aligned``: x, B and C start at 16 bytes."""
    fits = all(v % 16 == 0 and 16 <= v <= TC_MAX[k]
               for k, v in (("p", p), ("n", n), ("chunk", chunk)))
    if dtype == torch.bfloat16 and fits and aligned:
        return "tensor_core"
    return "cuda_core"


def ssd(x, dt, A, B, C, D, *, chunk: int, variant: str | None = None):
    """x: [Bt, S, H, P]; dt: [Bt, S, H] f32; A, D: [H] f32; B, C:
    [Bt, S, G, N] in x's dtype (H % G == 0); contiguous CUDA tensors.
    Returns (y [Bt, S, H, P] in x's dtype, final state [Bt, H, N, P] f32).
    ``variant``: None picks :func:`variant_for`'s; naming one launches that
    one or raises."""
    _build.check_no_grad("ssd", x=x, dt=dt, A=A, B=B, C=C, D=D)
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
    code = _build.compute_code(x, "x")
    if variant is None:
        aligned = all(t.data_ptr() % 16 == 0 for t in (x, B, C))
        variant = variant_for(x.dtype, p, n, int(chunk), aligned)
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {sorted(VARIANTS)}, "
                         f"got {variant!r}")
    y = torch.empty_like(x)
    state = torch.empty((bt, h, n, p), dtype=torch.float32, device=dev)
    lib = _build.load(LIBRARY, SOURCES, _bind)
    # the tensor-core variant's C B^T, one set per (sequence, chunk, group)
    scratch = None
    if variant == "tensor_core":
        floats = lib.ssd_tc_scratch_floats(bt, s, g, int(chunk))
        if floats:
            scratch = torch.empty(floats, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.ssd(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                      C.data_ptr(), D.data_ptr(), y.data_ptr(),
                      state.data_ptr(),
                      None if scratch is None else scratch.data_ptr(), bt, s,
                      h, p, g, n, int(chunk), code, VARIANTS[variant],
                      _build.stream_of(dev))
    if err == _build.CUDA_ERROR_INVALID_VALUE:
        raise ValueError(
            f"ssd ({variant}) refused {x.dtype} P={p}, N={n}, H={h}, G={g}, "
            f"chunk={chunk} (CUDA error {err}): the tensor-core variant "
            "takes bf16 with P, N and the chunk multiples of 16 up to 64, "
            "128 and 128 and x, B, C aligned to 16 bytes, the CUDA-core "
            "variant P and N that are multiples of 4 up to 64 and 128, "
            "chunks of 1 to 128 and pointers aligned to 4 elements "
            "(csrc/ssd.cu)")
    if err:
        raise RuntimeError(f"ssd launch failed: CUDA error {err}")
    LAUNCHES["ssd"] += 1
    if variant == "tensor_core":
        LAUNCHES["ssd_tc"] += 1
    return y, state
