"""Public flash attention with backend dispatch (a port of
``repro.kernels.flash_attention.ops``).

The reference's rule is ``use_pallas=_on_tpu()``; here the card takes the
TPU's place: ``use_kernel=None`` launches the CUDA kernel on CUDA tensors
and runs the plain oracle (:func:`ref.mha`) on CPU tensors.  Asking for the
kernel on CPU tensors raises -- there is no quiet fallback."""
from __future__ import annotations

from repro_torch.kernels.flash_attention import kernel as _k
from repro_torch.kernels.flash_attention import ref as _ref


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, scale: float | None = None,
                    use_kernel: bool | None = None):
    """GQA flash attention. q: [B, Hq, Sq, D]; k, v: [B, Hkv, Skv, D]."""
    if use_kernel is None:
        use_kernel = q.device.type == "cuda"
    if not use_kernel:
        return _ref.mha(q, k, v, causal=causal, window=window, scale=scale)
    return _k.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=causal, window=window, scale=scale)
