"""paddle_tpu_torch.optimizer — ``SGD``, ``Momentum``, ``Adam``, ``AdamW``,
gradient clipping and the LR schedulers (``lr``)."""
from . import lr  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue)
from .optimizer import (SGD, Adam, AdamW, Momentum,  # noqa: F401
                        Optimizer)

__all__ = ["lr", "Optimizer", "SGD", "Momentum", "Adam", "AdamW",
           "ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm"]
