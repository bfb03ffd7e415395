"""paddle_tpu_torch.optimizer — ``Adam``, ``AdamW`` and gradient clipping."""
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue)
from .optimizer import Adam, AdamW, Optimizer  # noqa: F401

__all__ = ["Optimizer", "Adam", "AdamW", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm"]
