"""Weight initializers: ``Constant``, ``Normal``, ``Uniform``,
``XavierUniform`` and ``KaimingUniform``.

Port of the ones of ``paddle_tpu/nn/initializer.py`` that the port's layers
use (the convolutions take ``KaimingUniform`` and a ``Uniform`` bias). Each is
``init(shape, dtype) -> torch.Tensor`` on the CPU, drawn from the CPU
generator of ``framework.random`` (``seed`` controls determinism); the
trainer moves parameters to the card.
"""
from __future__ import annotations

import math

import torch

from ..framework.random import get_generator

__all__ = ["Initializer", "Constant", "Normal", "Uniform", "XavierUniform",
           "KaimingUniform", "initializer_of"]


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


def initializer_of(attr, default):
    """A layer's ``weight_attr``/``bias_attr`` read as the reference's
    ``_to_initializer``: an ``Initializer`` is used, anything else (None,
    a name) leaves the layer's ``default``."""
    return attr if isinstance(attr, Initializer) else default
