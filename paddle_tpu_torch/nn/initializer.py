"""Weight initializers, ``ParamAttr`` and ``set_global_initializer``.

Port of ``paddle_tpu/nn/initializer.py``: ``Constant``, ``Normal``,
``TruncatedNormal`` (cut at two standard deviations), ``Uniform``,
``XavierUniform``/``XavierNormal``, ``KaimingUniform``/``KaimingNormal``,
``Assign`` and ``Bilinear`` (the transposed convolution's bilinear
upsampling kernel). Each is ``init(shape, dtype) -> torch.Tensor`` on the
CPU, drawn from the CPU generator of ``framework.random`` (``seed``
controls determinism; the numbers are not the reference's, only their
law); the trainer moves parameters to the card.

``ParamAttr`` bundles a parameter's initializer, learning-rate scale and
trainability. ``Layer.create_parameter`` resolves a parameter's
initializer as the reference does: the attribute's, else the global one
(:func:`set_global_initializer`), else the layer's own default.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..framework.random import get_generator

__all__ = ["Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
           "XavierUniform", "XavierNormal", "KaimingUniform", "KaimingNormal",
           "Assign", "Bilinear", "ParamAttr", "set_global_initializer",
           "initializer_of"]


def _fan_in_out(shape):
    shape = tuple(shape)
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:   # Linear weights are (in, out)
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


class Initializer:
    def __call__(self, shape, dtype) -> torch.Tensor:
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, shape, dtype):
        return torch.full(tuple(shape), self.value, dtype=dtype)


class Normal(Initializer):
    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype):
        x = torch.randn(tuple(shape), generator=get_generator("cpu"))
        return (self.mean + self.std * x).to(dtype)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain: float = 1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype):
        fi, fo = _fan_in_out(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        u = torch.rand(tuple(shape), generator=get_generator("cpu"))
        return (u * (2.0 * limit) - limit).to(dtype)


class Uniform(Initializer):
    def __init__(self, low: float = -1.0, high: float = 1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype):
        u = torch.rand(tuple(shape), generator=get_generator("cpu"))
        return (self.low + u * (self.high - self.low)).to(dtype)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope: float = 0.0):
        self.fan_in, self.negative_slope = fan_in, negative_slope

    def __call__(self, shape, dtype):
        fi = self.fan_in if self.fan_in is not None else _fan_in_out(shape)[0]
        gain = math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        return Uniform(-gain * math.sqrt(3.0 / fi),
                       gain * math.sqrt(3.0 / fi))(shape, dtype)


class TruncatedNormal(Initializer):
    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype):
        x = torch.empty(tuple(shape))
        torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0,
                                    generator=get_generator("cpu"))
        return (self.mean + self.std * x).to(dtype)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain: float = 1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype):
        fi, fo = _fan_in_out(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return Normal(0.0, std)(shape, dtype)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope: float = 0.0):
        self.fan_in, self.negative_slope = fan_in, negative_slope

    def __call__(self, shape, dtype):
        fi = self.fan_in if self.fan_in is not None else _fan_in_out(shape)[0]
        gain = math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        return Normal(0.0, gain / math.sqrt(fi))(shape, dtype)


class Assign(Initializer):
    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype):
        v = torch.as_tensor(np.asarray(self.value)).to(dtype)
        return v.reshape(tuple(shape)).clone()


class Bilinear(Initializer):
    """The bilinear-interpolation kernel of a transposed convolution's
    (C_out, C_in, H, W) weight: every spatial kernel is the separable
    triangle filter of the upsampling factor, so the layer starts as
    exact bilinear upsampling."""

    def __call__(self, shape, dtype):
        if len(shape) != 4:
            raise ValueError(
                f"Bilinear initializer needs a 4-D conv weight, got {shape}")
        h, w = shape[2], shape[3]
        f_h, f_w = (h + 1) // 2, (w + 1) // 2
        c_h = (2 * f_h - 1 - f_h % 2) / (2.0 * f_h)
        c_w = (2 * f_w - 1 - f_w % 2) / (2.0 * f_w)
        ys = (1 - np.abs(np.arange(h) / f_h - c_h))[:, None]
        xs = (1 - np.abs(np.arange(w) / f_w - c_w))[None, :]
        kern = torch.from_numpy((ys * xs).astype(np.float32))
        return kern.expand(tuple(shape)).to(dtype).clone()


# the process-wide defaults Layer.create_parameter consults when a
# parameter's attribute names no initializer
_global_init = {"weight": None, "bias": None}


def set_global_initializer(weight_init, bias_init=None):
    """Set (or clear, with None) the process-wide default weight and bias
    initializers."""
    for init, what in ((weight_init, "weight_init"),
                       (bias_init, "bias_init")):
        if init is not None and not isinstance(init, Initializer):
            raise TypeError(f"{what} must be an Initializer or None")
    _global_init["weight"] = weight_init
    _global_init["bias"] = bias_init


def global_initializer(is_bias: bool):
    return _global_init["bias" if is_bias else "weight"]


class ParamAttr:
    """A parameter's attributes: name, initializer, learning-rate scale,
    regularizer, trainability and whether gradient clipping applies."""

    def __init__(self, name=None, initializer=None, learning_rate: float = 1.0,
                 regularizer=None, trainable: bool = True,
                 need_clip: bool = True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip


def initializer_of(attr, default):
    """A layer's ``weight_attr``/``bias_attr`` read as the reference's
    ``_to_initializer``: an ``Initializer``, or a ``ParamAttr``'s, is
    used; anything else (None, a name) leaves the layer's ``default``."""
    if isinstance(attr, ParamAttr) and attr.initializer is not None:
        return attr.initializer
    return attr if isinstance(attr, Initializer) else default
