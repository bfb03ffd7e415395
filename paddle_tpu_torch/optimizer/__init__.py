"""paddle_tpu_torch.optimizer — the eleven optimizers of the reference
(``SGD``, ``Momentum``, ``DGCMomentum``, ``Adagrad``, ``Adadelta``,
``Adam``, ``AdamW``, ``Adamax``, ``RMSProp``, ``Lamb``, ``Lars`` and its
alias ``LarsMomentum``), gradient clipping and the LR schedulers (``lr``)."""
from . import lr  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue)
from .optimizer import (SGD, Adadelta, Adagrad, Adam,  # noqa: F401
                        Adamax, AdamW, DGCMomentum, Lamb, Lars,
                        LarsMomentum, Momentum, Optimizer, RMSProp)

__all__ = ["lr", "Optimizer", "SGD", "Momentum", "DGCMomentum", "Adagrad",
           "Adadelta", "Adam", "AdamW", "Adamax", "RMSProp", "Lamb", "Lars",
           "LarsMomentum", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm"]
