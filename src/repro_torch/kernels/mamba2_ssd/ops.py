"""Public Mamba2 SSD scan with backend dispatch (a port of
``repro.kernels.mamba2_ssd.ops``).

The reference's rule is ``use_pallas=_on_tpu()``; here the card takes the
TPU's place: ``use_kernel=None`` launches the CUDA kernel K5 on CUDA
tensors and runs the plain version (:func:`ref.ssd_chunked`) on CPU
tensors.  Asking for the kernel on CPU tensors raises -- there is no quiet
fallback.  Unlike the reference, :func:`ssd` returns the final state beside
``y`` and takes any sequence length."""
from __future__ import annotations

from repro_torch.kernels.mamba2_ssd import kernel as _k
from repro_torch.kernels.mamba2_ssd import ref as _ref

ssd_decode_step = _ref.ssd_decode_step


def ssd(x, dt, A, B, C, D, *, chunk: int = 128,
        use_kernel: bool | None = None):
    """Mamba2 SSD scan: x [Bt,S,H,P], dt [Bt,S,H], A [H], B/C [Bt,S,G,N],
    D [H] -> (y [Bt,S,H,P], final state [Bt,H,N,P] f32).  The chunk is
    ``min(chunk, S)``, as in the reference."""
    chunk = max(1, min(chunk, x.shape[1]))
    if use_kernel is None:
        use_kernel = x.device.type == "cuda"
    if not use_kernel:
        return _ref.ssd_chunked(x, dt, A, B, C, D, chunk=chunk)
    return _k.ssd(x.contiguous(), dt.float().contiguous(),
                  A.float().contiguous(), B.contiguous(), C.contiguous(),
                  D.float().contiguous(), chunk=chunk)
