"""The Mamba2 SSD scan: the plain oracles (``ref``), the CUDA kernel K5
(``kernel``) and the dispatch (``ops``)."""
from repro_torch.kernels.mamba2_ssd.ops import ssd, ssd_decode_step  # noqa: F401
