from repro_torch.models.config import ModelConfig  # noqa: F401
from repro_torch.models.model import Model  # noqa: F401
