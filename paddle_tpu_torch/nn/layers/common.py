"""The common layers (port of ``paddle_tpu/nn/layers/common.py``):
``Identity``, ``Linear``, ``Embedding``, the dropouts, ``Flatten``, the
``Upsample`` layers, ``Bilinear``, ``CosineSimilarity``,
``PairwiseDistance``, the pads, ``Fold`` and ``Unfold``."""
from __future__ import annotations

import torch

from .. import functional as F
from ..initializer import Normal, XavierUniform, initializer_of
from ..layer import Layer

__all__ = ["Identity", "Linear", "Embedding", "Dropout", "Dropout2D",
           "Dropout3D", "AlphaDropout", "Flatten", "Upsample",
           "UpsamplingNearest2D", "UpsamplingBilinear2D", "Bilinear",
           "CosineSimilarity", "PairwiseDistance", "Pad1D", "Pad2D", "Pad3D",
           "ZeroPad2D", "Unfold", "Fold"]


class Identity(Layer):
    def forward(self, x):
        return x


class Linear(Layer):
    """y = x W + b with weight (in_features, out_features)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = self.create_parameter(
            (in_features, out_features), attr=weight_attr,
            initializer=initializer_of(weight_attr, XavierUniform()))
        self.bias = None if bias_attr is False else self.create_parameter(
            (out_features,), attr=bias_attr, is_bias=True)

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
            (num_embeddings, embedding_dim), attr=weight_attr,
            initializer=initializer_of(weight_attr, XavierUniform()))
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


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout2d(x, p=self.p, training=self.training,
                           data_format=self.data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout3d(x, p=self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, p=self.p, training=self.training)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return torch.flatten(x, self.start_axis, self.stop_axis)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size, self.scale_factor = size, scale_factor
        self.mode, self.align_corners = mode, align_corners
        self.align_mode, self.data_format = align_mode, data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False, 0, data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0, data_format)


class Bilinear(Layer):
    """``out = x1 W x2 + b`` with weight (out, in1, in2)."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self.weight = self.create_parameter(
            (out_features, in1_features, in2_features), attr=weight_attr,
            initializer=initializer_of(weight_attr, Normal(0, 0.02)))
        self.bias = None if bias_attr is False else self.create_parameter(
            (out_features,), attr=bias_attr, is_bias=True)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)


class PairwiseDistance(Layer):
    """``||x - y + epsilon||_p`` over the last axis."""

    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        d = (x - y + self.epsilon).abs() ** self.p
        return d.sum(dim=-1, keepdim=self.keepdim) ** (1.0 / self.p)


class _PadNd(Layer):
    def __init__(self, padding, mode, value, data_format, n):
        super().__init__()
        self.padding = [padding] * (2 * n) if isinstance(padding, int) \
            else padding
        self.mode, self.value, self.data_format = mode, value, data_format

    def forward(self, x):
        return F.pad(x, self.padding, mode=self.mode, value=self.value,
                     data_format=self.data_format)


class Pad1D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCL", name=None):
        super().__init__(padding, mode, value, data_format, 1)


class Pad2D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__(padding, mode, value, data_format, 2)


class Pad3D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format, 3)


class ZeroPad2D(Pad2D):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.kernel_sizes, self.strides = kernel_sizes, strides
        self.paddings, self.dilations = paddings, dilations

    def forward(self, x):
        return F.unfold(x, self.kernel_sizes, self.strides, self.paddings,
                        self.dilations)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.output_sizes, self.kernel_sizes = output_sizes, kernel_sizes
        self.strides, self.paddings = strides, paddings
        self.dilations = dilations

    def forward(self, x):
        return F.fold(x, self.output_sizes, self.kernel_sizes, self.strides,
                      self.paddings, self.dilations)
