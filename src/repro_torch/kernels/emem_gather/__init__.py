"""Import shim: the paged gathers and scatter live in
``repro_torch.kernels.paged_decode`` (``gather*.py``), as in the reference.
Kept so that ``from repro_torch.kernels.emem_gather import ...`` and the
``kernel``/``ref``/``ops`` submodule names work as the reference's do."""
from repro_torch.kernels.paged_decode import gather as kernel  # noqa: F401
from repro_torch.kernels.paged_decode import gather_ops as ops  # noqa: F401
from repro_torch.kernels.paged_decode import gather_ref as ref  # noqa: F401
from repro_torch.kernels.paged_decode.gather_ops import (  # noqa: F401
    gather_pages, gather_slots, scatter_slots)
