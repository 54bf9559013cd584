from repro_torch.train.checkpoint import CheckpointManager  # noqa: F401
from repro_torch.train.trainer import TrainConfig, Trainer  # noqa: F401
