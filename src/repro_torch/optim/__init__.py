from repro_torch.optim import adamw, schedules  # noqa: F401
from repro_torch.optim.adamw import AdamWConfig  # noqa: F401
