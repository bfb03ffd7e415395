"""Weight-decay regularizers ``L1Decay`` and ``L2Decay``.

Port of ``paddle_tpu/regularizer.py``: plain config objects that an
optimizer reads in ``apply_gradients`` (``optimizer/optimizer.py``). As
``weight_decay`` of a coupled optimizer (Adam), ``L2Decay`` adds
``coeff * p`` to the gradient and ``L1Decay`` adds ``coeff * sign(p)``; a
decoupled one (AdamW) takes the coefficient alone, ``p - lr * coeff * p``,
as the reference does.
"""
from __future__ import annotations

import torch

__all__ = ["WeightDecayRegularizer", "L1Decay", "L2Decay"]


class WeightDecayRegularizer:
    kind = "l2"

    def __init__(self, coeff: float = 0.0):
        self.coeff = float(coeff)
        # the legacy name the reference's fluid-era code reads
        self._regularization_coeff = float(coeff)

    def __call__(self, param, grad):
        """The decay term to add to ``grad`` (float32)."""
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}(coeff={self.coeff})"


class L1Decay(WeightDecayRegularizer):
    """L1 weight decay: grad += coeff * sign(param)."""
    kind = "l1"

    def __call__(self, param, grad):
        return self.coeff * torch.sign(param)


class L2Decay(WeightDecayRegularizer):
    """L2 weight decay: grad += coeff * param."""
    kind = "l2"

    def __call__(self, param, grad):
        return self.coeff * param
