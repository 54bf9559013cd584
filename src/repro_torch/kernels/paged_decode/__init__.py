"""Paged decode over the pooled KV memory: the composed oracle (``ref``),
the VM-walking CUDA kernels (``kernel``) and the impl selection (``ops``)."""
from repro_torch.kernels.paged_decode.ops import (paged_decode_shard,  # noqa: F401
                                                  resolve_impl)
