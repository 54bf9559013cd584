"""Flash attention over whole sequences: the plain oracle (``ref``), the
CUDA kernel K3 (``kernel``) and the dispatch (``ops``)."""
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: F401
