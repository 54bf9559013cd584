"""Import shim: flash decode lives in ``repro_torch.kernels.paged_decode``
(``flash*.py``), as in the reference.  Kept so that
``from repro_torch.kernels.decode_attention import ...`` and the
``kernel``/``ref``/``ops`` submodule names work as the reference's do."""
from repro_torch.kernels.paged_decode import flash as kernel  # noqa: F401
from repro_torch.kernels.paged_decode import flash_ops as ops  # noqa: F401
from repro_torch.kernels.paged_decode import flash_ref as ref  # noqa: F401
from repro_torch.kernels.paged_decode.flash_ops import (  # noqa: F401
    decode_attention, decode_attention_partial, merge_partials)
