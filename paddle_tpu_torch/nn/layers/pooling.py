"""Pooling layers (port of ``paddle_tpu/nn/layers/pooling.py``, whole):
each holds its functional's arguments; ``return_mask`` and
``divisor_override`` are dropped, as the reference drops them."""
from __future__ import annotations

from .. import functional as F
from ..layer import Layer

__all__ = ["MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D",
           "AvgPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
           "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
           "AdaptiveMaxPool3D"]


class _Pool(Layer):
    def __init__(self, fn, kernel_size=None, stride=None, padding=0, **kw):
        super().__init__()
        self._fn = fn
        self.kernel_size, self.stride, self.padding = (kernel_size, stride,
                                                       padding)
        self._kw = kw

    def forward(self, x):
        return self._fn(x, self.kernel_size, self.stride, self.padding,
                        **self._kw)


class MaxPool1D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, name=None):
        super().__init__(F.max_pool1d, kernel_size, stride, padding,
                         ceil_mode=ceil_mode)


class MaxPool2D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__(F.max_pool2d, kernel_size, stride, padding,
                         ceil_mode=ceil_mode, data_format=data_format)


class MaxPool3D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCDHW", name=None):
        super().__init__(F.max_pool3d, kernel_size, stride, padding,
                         ceil_mode=ceil_mode, data_format=data_format)


class AvgPool1D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__(F.avg_pool1d, kernel_size, stride, padding,
                         exclusive=exclusive, ceil_mode=ceil_mode)


class AvgPool2D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__(F.avg_pool2d, kernel_size, stride, padding,
                         ceil_mode=ceil_mode, exclusive=exclusive,
                         data_format=data_format)


class AvgPool3D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCDHW",
                 name=None):
        super().__init__(F.avg_pool3d, kernel_size, stride, padding,
                         ceil_mode=ceil_mode, exclusive=exclusive,
                         data_format=data_format)


class _AdaptivePool(Layer):
    def __init__(self, fn, output_size, **kw):
        super().__init__()
        self._fn = fn
        self.output_size = output_size
        self._kw = kw

    def forward(self, x):
        return self._fn(x, self.output_size, **self._kw)


class AdaptiveAvgPool1D(_AdaptivePool):
    def __init__(self, output_size, name=None):
        super().__init__(F.adaptive_avg_pool1d, output_size)


class AdaptiveAvgPool2D(_AdaptivePool):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__(F.adaptive_avg_pool2d, output_size,
                         data_format=data_format)


class AdaptiveAvgPool3D(_AdaptivePool):
    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__(F.adaptive_avg_pool3d, output_size,
                         data_format=data_format)


class AdaptiveMaxPool1D(_AdaptivePool):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(F.adaptive_max_pool1d, output_size)


class AdaptiveMaxPool2D(_AdaptivePool):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(F.adaptive_max_pool2d, output_size)


class AdaptiveMaxPool3D(_AdaptivePool):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(F.adaptive_max_pool3d, output_size)
