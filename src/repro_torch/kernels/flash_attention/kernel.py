"""K3: the hand-written CUDA flash-attention kernel -- build, binding,
wrapper.

``csrc/flash_attention.cu`` holds the kernel in two variants (its header
comment gives the design and the bound): ``"tensor_core"``, bf16 products
on the tensor cores with f32 accumulation, and ``"cuda_core"``, f32
arithmetic on the CUDA cores.  :func:`flash_attention` picks one with
:func:`variant_for` before the launch (the tensor cores for bf16 at head
dims 64 and 128 with K/V aligned to 16 bytes, the CUDA cores for the rest);
it never falls back on a failure.  It launches on the current stream,
building the library with ``nvcc`` at first use
(:mod:`repro_torch.kernels.build`), and adds one to
``LAUNCHES["flash_attention"]`` and, for the tensor-core variant, to
``LAUNCHES["flash_attention_tc"]``; any failure raises, and so do CPU
tensors: a CUDA kernel has no interpret mode.  Its plain version is
:func:`repro_torch.kernels.flash_attention.ref.mha`.
"""
from __future__ import annotations

from pathlib import Path

import torch

from repro_torch.kernels import build as _build

#: launches since the last :func:`reset_launch_counts`: every launch, and
#: those of the tensor-core variant
LAUNCHES = {"flash_attention": 0, "flash_attention_tc": 0}

SOURCES = (Path(__file__).resolve().parent / "csrc" / "flash_attention.cu",)
LIBRARY = "flash_attention"

#: the variants, by their code in the C entry
VARIANTS = {"cuda_core": 0, "tensor_core": 1}
#: head dims the tensor-core variant takes (bf16 only)
TC_HEAD_DIMS = (64, 128)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build() -> tuple[Path, str]:
    """Build this library (see :func:`repro_torch.kernels.build.build`)."""
    return _build.build(LIBRARY, SOURCES)


def _bind(lib) -> None:
    import ctypes
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention.argtypes = [p] * 4 + [i] * 8 + [f, i, i, p]
    lib.flash_attention.restype = i


def variant_for(dtype: torch.dtype, d: int, aligned: bool = True) -> str:
    """The variant :func:`flash_attention` launches for ``dtype`` and head
    dim ``d``; ``aligned``: K and V start at 16 bytes and q at 4."""
    if dtype == torch.bfloat16 and d in TC_HEAD_DIMS and aligned:
        return "tensor_core"
    return "cuda_core"


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, scale: float | None = None,
                    variant: str | None = None):
    """q: [B, Hq, Sq, D]; k, v: [B, Hkv, Skv, D] (Hq % Hkv == 0, one dtype,
    contiguous CUDA tensors) -> [B, Hq, Sq, D] in q's dtype.  Sq <= Skv
    unless ``causal`` is off and there is no window: the queries sit at the
    tail of the KV sequence, which a causal or windowed mask reads and a
    full one does not (Sq > Skv: cross-attention to a shorter source).
    ``variant``: None picks :func:`variant_for`'s; naming one launches that
    one or raises."""
    _build.check_no_grad("flash_attention", q=q, k=k, v=v)
    dev = _build.check_cuda(q=q, k=k, v=v)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be [B, Hq, Sq, D] and k, v [B, Hkv, Skv, D], "
                         f"got {tuple(q.shape)} / {tuple(k.shape)} / "
                         f"{tuple(v.shape)}")
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    masked = causal or window is not None
    if k.shape[0] != b or k.shape[3] != d or hq % max(hkv, 1) \
            or (masked and sq > skv):
        raise ValueError(f"q {tuple(q.shape)} does not fit k/v "
                         f"{tuple(k.shape)}: needs one batch and head dim, "
                         "Hq % Hkv == 0 and, causal or windowed, Sq <= Skv")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share a dtype, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    code = _build.compute_code(q, "q")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if variant is None:
        aligned = (k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0
                   and q.data_ptr() % 4 == 0)
        variant = variant_for(q.dtype, d, aligned)
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {sorted(VARIANTS)}, "
                         f"got {variant!r}")
    scale = d ** -0.5 if scale is None else float(scale)
    out = torch.empty_like(q)
    lib = _build.load(LIBRARY, SOURCES, _bind)
    with torch.cuda.device(dev):
        err = lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
            hkv, sq, skv, d, int(causal), 0 if window is None else int(window),
            scale, code, VARIANTS[variant], _build.stream_of(dev))
    if err == _build.CUDA_ERROR_INVALID_VALUE:
        raise ValueError(
            f"flash_attention ({variant}) refused {q.dtype} D={d}, Hq={hq}, "
            f"Hkv={hkv}, Sq={sq}, Skv={skv} (CUDA error {err}): the "
            "tensor-core variant takes bf16 at D 64 or 128 with K/V aligned "
            "to 16 bytes, the CUDA-core variant head dims that are multiples "
            "of 4 up to 256 and pointers aligned to 4 elements "
            "(csrc/flash_attention.cu)")
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    LAUNCHES["flash_attention"] += 1
    if variant == "tensor_core":
        LAUNCHES["flash_attention_tc"] += 1
    return out
