"""``LayerNorm`` (port of ``paddle_tpu/nn/layers/norm.py``'s)."""
from __future__ import annotations

from .. import functional as F
from ..initializer import Constant
from ..layer import Layer

__all__ = ["LayerNorm"]


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        self.weight = None if weight_attr is False else self.create_parameter(
            self.normalized_shape, initializer=weight_attr or Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            self.normalized_shape, initializer=bias_attr or None,
            is_bias=True)

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)

    def extra_repr(self):
        return f"normalized_shape={self.normalized_shape}"
