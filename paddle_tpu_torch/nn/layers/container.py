"""``LayerList`` (port of ``paddle_tpu/nn/layers/container.py``'s): an
``nn.ModuleList`` whose sublayers are named ``"0"``, ``"1"``, ... as the
reference names them."""
from __future__ import annotations

from torch import nn

from ..layer import Layer

__all__ = ["LayerList"]


class LayerList(Layer, nn.ModuleList):
    def __init__(self, sublayers=None):
        Layer.__init__(self)
        for layer in sublayers or []:
            self.append(layer)
