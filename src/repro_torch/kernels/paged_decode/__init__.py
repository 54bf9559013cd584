"""Paged decode over the pooled KV memory and the emulated memory's gathers:
the composed oracle (``ref``), the VM-walking CUDA kernels (``kernel``) and
the impl selection (``ops``); the slot and page gathers K7 and K6
(``gather``), their plain versions (``gather_ref``) and their selection
(``gather_ops``); flash decode over a contiguous cache, K4 (``flash``,
``flash_ref``, ``flash_ops``)."""
from repro_torch.kernels.paged_decode.flash_ops import (  # noqa: F401
    decode_attention, decode_attention_partial, merge_partials)
from repro_torch.kernels.paged_decode.gather_ops import (gather_pages,  # noqa: F401
                                                         gather_slots,
                                                         scatter_slots)
from repro_torch.kernels.paged_decode.ops import (paged_decode_shard,  # noqa: F401
                                                  resolve_impl)
