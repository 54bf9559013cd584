"""Build, load and argument checks shared by the port's CUDA kernel
libraries.

Each library is one or more ``.cu`` sources compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, at first use,
and bound with ``ctypes``.  Outputs go to ``build/repro_torch_kernels/`` at
the checkout's root (listed in .gitignore), keyed by a hash of the sources,
the shared headers in ``kernels/csrc/`` and the flags, so a changed source
is rebuilt and an unchanged one is not.  Several libraries may build at
once: each writes a temporary file and renames it into place.
"""
from __future__ import annotations

import hashlib
import os
import shutil
from pathlib import Path

import torch

#: headers every library may include (``#include "common.cuh"``)
INCLUDE_DIR = Path(__file__).resolve().parent / "csrc"
#: the checkout's root is three levels above this file's package
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: dtype codes of the C entries
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
CUDA_ERROR_INVALID_VALUE = 1

_loaded: dict[str, object] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
                       "the port's CUDA kernels are built from source at first use")


def library_path(name: str, sources) -> Path:
    """Where the shared library ``name`` built from ``sources`` lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [*sources, *sorted(INCLUDE_DIR.glob("*.cuh"))]:
        h.update(Path(src).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str, sources) -> tuple[Path, str]:
    """Compile ``sources`` with nvcc unless a library for exactly these
    sources already exists.  Returns (library path, compiler log); the log
    holds ptxas' register and shared-memory report."""
    import subprocess
    out = library_path(name, sources)
    log_path = out.with_suffix(".log")
    if out.exists():
        return out, log_path.read_text() if log_path.exists() else ""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(INCLUDE_DIR), "-o", str(tmp),
           *map(str, sources)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    log = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n{log}")
    log_path.write_text(log)
    os.replace(tmp, out)
    return out, log


def load(name: str, sources, bind):
    """The loaded library ``name``, built at first use; ``bind(lib)`` sets
    its entries' ctypes signatures once."""
    if name not in _loaded:
        import ctypes
        path, _ = build(name, sources)
        lib = ctypes.CDLL(str(path))
        bind(lib)
        _loaded[name] = lib
    return _loaded[name]


def dtype_code(t: torch.Tensor, what: str) -> int:
    """The C entries' code for ``t``'s dtype; fp8 raises NotImplementedError,
    any other dtype TypeError."""
    if t.dtype in DTYPE_CODE:
        return DTYPE_CODE[t.dtype]
    if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        raise NotImplementedError(
            f"{what}: fp8 KV is not supported by the CUDA kernels yet")
    raise TypeError(f"{what}: unsupported dtype {t.dtype}")


def check_cuda(**tensors) -> torch.device:
    """All tensors contiguous and on one CUDA device, which is returned; a
    CPU tensor raises (a CUDA kernel has no interpret mode)."""
    dev = None
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}, expected a CUDA tensor")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, others on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        dev = t.device
    return dev


def stream_of(dev: torch.device) -> int:
    """PyTorch's current stream on ``dev``, as the C entries take it."""
    return torch.cuda.current_stream(dev).cuda_stream
