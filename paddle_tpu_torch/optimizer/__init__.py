"""paddle_tpu_torch.optimizer — ``Adam``, ``AdamW``, gradient clipping and
the LR schedulers (``lr``)."""
from . import lr  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue)
from .optimizer import Adam, AdamW, Optimizer  # noqa: F401

__all__ = ["lr", "Optimizer", "Adam", "AdamW", "ClipGradByValue",
           "ClipGradByNorm", "ClipGradByGlobalNorm"]
