"""``Linear``, ``Embedding`` and ``Dropout`` (port of
``paddle_tpu/nn/layers/common.py``'s)."""
from __future__ import annotations

import torch

from .. import functional as F
from ..initializer import XavierUniform
from ..layer import Layer

__all__ = ["Linear", "Embedding", "Dropout"]


class Linear(Layer):
    """y = x W + b with weight (in_features, out_features)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = self.create_parameter(
            (in_features, out_features),
            initializer=weight_attr or XavierUniform())
        self.bias = None if bias_attr is False else self.create_parameter(
            (out_features,), initializer=bias_attr or None, is_bias=True)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self.in_features}, out_features={self.out_features}"


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = padding_idx if padding_idx is None or \
            padding_idx >= 0 else num_embeddings + padding_idx
        self.weight = self.create_parameter(
            (num_embeddings, embedding_dim),
            initializer=weight_attr or XavierUniform())
        if self.padding_idx is not None:
            with torch.no_grad():
                self.weight[self.padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self.padding_idx)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, p=self.p, axis=self.axis, training=self.training,
                         mode=self.mode)
