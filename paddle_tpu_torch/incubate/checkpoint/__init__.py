"""paddle_tpu_torch.incubate.checkpoint (port of
``paddle_tpu/incubate/checkpoint``; reference
python/paddle/fluid/incubate/checkpoint/auto_checkpoint.py)."""
from . import auto_checkpoint  # noqa: F401
from .auto_checkpoint import (AutoCheckpointChecker,  # noqa: F401
                              TrainEpochRange, train_epoch_range)

__all__ = ["auto_checkpoint", "AutoCheckpointChecker", "TrainEpochRange",
           "train_epoch_range"]
