"""Convolution layers (port of ``paddle_tpu/nn/layers/conv.py``, whole).

The weight is ``(out, in/groups, *K)``, ``(in, out/groups, *K)`` when
transposed, drawn ``KaimingUniform(fan_in)``; the bias ``Uniform(±1/√fan_in)``
unless ``bias_attr=False``; ``fan_in = in/groups · prod(K)``, as the
reference's."""
from __future__ import annotations

import math

from .. import functional as F
from ..initializer import KaimingUniform, Uniform, initializer_of
from ..layer import Layer

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose"]


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, n, transpose,
                 stride=1, padding=0, output_padding=0, dilation=1, groups=1,
                 padding_mode="zeros", weight_attr=None, bias_attr=None,
                 data_format=None):
        super().__init__()
        self._n = n
        self._transpose = transpose
        self.in_channels = in_channels
        self.out_channels = out_channels
        k = ((kernel_size,) * n if isinstance(kernel_size, int)
             else tuple(kernel_size))
        self.kernel_size = k
        self.stride = stride
        self.padding = padding
        self.output_padding = output_padding
        self.dilation = dilation
        self.groups = groups
        self.padding_mode = padding_mode
        self.data_format = data_format
        wshape = ((in_channels, out_channels // groups) + k if transpose
                  else (out_channels, in_channels // groups) + k)
        fan_in = in_channels // groups * math.prod(k)
        self.weight = self.create_parameter(
            wshape,
            initializer=initializer_of(weight_attr,
                                       KaimingUniform(fan_in=fan_in)))
        if bias_attr is False:
            self.bias = None
        else:
            bound = 1.0 / math.sqrt(fan_in)
            self.bias = self.create_parameter(
                (out_channels,), is_bias=True,
                initializer=initializer_of(bias_attr,
                                           Uniform(-bound, bound)))

    def extra_repr(self):
        return (f"{self.in_channels}, {self.out_channels}, "
                f"kernel_size={self.kernel_size}, stride={self.stride}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1, False,
                         stride, padding, 0, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, False,
                         stride, padding, 0, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3, False,
                         stride, padding, 0, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)


class Conv1DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1, True,
                         stride, padding, output_padding, dilation, groups,
                         "zeros", weight_attr, bias_attr, data_format)

    def forward(self, x, output_size=None):
        return F.conv1d_transpose(x, self.weight, self.bias, self.stride,
                                  self.padding, self.output_padding,
                                  self.groups, self.dilation, output_size,
                                  self.data_format)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, True,
                         stride, padding, output_padding, dilation, groups,
                         "zeros", weight_attr, bias_attr, data_format)

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(x, self.weight, self.bias, self.stride,
                                  self.padding, self.output_padding,
                                  self.groups, self.dilation, output_size,
                                  self.data_format)


class Conv3DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3, True,
                         stride, padding, output_padding, dilation, groups,
                         "zeros", weight_attr, bias_attr, data_format)

    def forward(self, x, output_size=None):
        return F.conv3d_transpose(x, self.weight, self.bias, self.stride,
                                  self.padding, self.output_padding,
                                  self.groups, self.dilation, output_size,
                                  self.data_format)
