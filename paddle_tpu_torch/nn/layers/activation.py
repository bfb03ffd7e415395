"""Activation layers (port of ``paddle_tpu/nn/layers/activation.py``,
whole): each calls its functional with the keyword arguments it was built
with; ``PReLU`` holds its weight, ``RReLU`` draws only in training."""
from __future__ import annotations

from .. import functional as F
from ..initializer import Constant, initializer_of
from ..layer import Layer

__all__ = ["CELU", "ELU", "GELU", "Hardshrink", "Hardsigmoid", "Hardswish",
           "Hardtanh", "LogSigmoid", "Mish", "ReLU", "ReLU6", "SELU",
           "Sigmoid", "Silu", "Softplus", "Softshrink", "Softsign", "Swish",
           "Tanh", "Tanhshrink", "ThresholdedReLU", "LeakyReLU", "PReLU",
           "RReLU", "Softmax", "LogSoftmax", "Maxout", "GLU"]


def _simple(name, fn_name):
    fn = getattr(F, fn_name)

    class _Act(Layer):
        def __init__(self, name=None, **kwargs):
            super().__init__()
            self._kwargs = {k: v for k, v in kwargs.items() if k != "name"}

        def forward(self, x):
            return fn(x, **self._kwargs)

    _Act.__name__ = _Act.__qualname__ = name
    return _Act


CELU = _simple("CELU", "celu")
ELU = _simple("ELU", "elu")
GELU = _simple("GELU", "gelu")
Hardshrink = _simple("Hardshrink", "hardshrink")
Hardsigmoid = _simple("Hardsigmoid", "hardsigmoid")
Hardswish = _simple("Hardswish", "hardswish")
Hardtanh = _simple("Hardtanh", "hardtanh")
LogSigmoid = _simple("LogSigmoid", "log_sigmoid")
Mish = _simple("Mish", "mish")
ReLU = _simple("ReLU", "relu")
ReLU6 = _simple("ReLU6", "relu6")
SELU = _simple("SELU", "selu")
Sigmoid = _simple("Sigmoid", "sigmoid")
Silu = _simple("Silu", "silu")
Softplus = _simple("Softplus", "softplus")
Softshrink = _simple("Softshrink", "softshrink")
Softsign = _simple("Softsign", "softsign")
Swish = _simple("Swish", "swish")
Tanh = _simple("Tanh", "tanh")
Tanhshrink = _simple("Tanhshrink", "tanhshrink")
ThresholdedReLU = _simple("ThresholdedReLU", "thresholded_relu")


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01, name=None):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, self.negative_slope)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        self.data_format = data_format
        self.weight = self.create_parameter(
            (num_parameters,),
            initializer=initializer_of(weight_attr, Constant(init)))

    def forward(self, x):
        return F.prelu(x, self.weight, data_format=self.data_format)


class RReLU(Layer):
    def __init__(self, lower=0.125, upper=1.0 / 3.0, name=None):
        super().__init__()
        self.lower, self.upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self.lower, self.upper, training=self.training)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.softmax(x, axis=self.axis)


class LogSoftmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.log_softmax(x, axis=self.axis)


class Maxout(Layer):
    def __init__(self, groups, axis=1, name=None):
        super().__init__()
        self.groups, self.axis = groups, axis

    def forward(self, x):
        return F.maxout(x, self.groups, self.axis)


class GLU(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.glu(x, axis=self.axis)
