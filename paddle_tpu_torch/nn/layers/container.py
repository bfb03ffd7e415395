"""``Sequential``, ``LayerList``, ``ParameterList`` and ``LayerDict`` (port
of ``paddle_tpu/nn/layers/container.py``): PyTorch's containers under the
reference's names. Sublayers and parameters are named ``"0"``, ``"1"``,
... (``Sequential`` also takes an ``OrderedDict`` or ``(name, layer)``
tuples), as the reference names them, so state names match 1:1."""
from __future__ import annotations

from collections import OrderedDict

from torch import nn

from ..layer import Layer

__all__ = ["Sequential", "LayerList", "ParameterList", "LayerDict"]


class Sequential(Layer, nn.Sequential):
    def __init__(self, *layers):
        Layer.__init__(self)
        if len(layers) == 1 and isinstance(layers[0], OrderedDict):
            for name, layer in layers[0].items():
                self.add_module(name, layer)
            return
        for i, layer in enumerate(layers):
            if isinstance(layer, tuple):
                self.add_module(layer[0], layer[1])
            else:
                self.add_module(str(i), layer)


class LayerList(Layer, nn.ModuleList):
    def __init__(self, sublayers=None):
        Layer.__init__(self)
        for layer in sublayers or []:
            self.append(layer)


class ParameterList(Layer, nn.ParameterList):
    def __init__(self, parameters=None):
        nn.ParameterList.__init__(self, parameters)


class LayerDict(Layer, nn.ModuleDict):
    def __init__(self, sublayers=None):
        Layer.__init__(self)
        if sublayers:
            self.update(sublayers)
