"""Activation functionals (port of
``paddle_tpu/nn/functional/activation.py``, whole): the reference's
formulas written out in PyTorch ops, with its defaults. ``rrelu`` in
training and ``gumbel_softmax`` draw from the generator of the tensor's
device (``framework.random``); the ``_`` variants return a value, as the
reference's do."""
from __future__ import annotations

import torch
import torch.nn.functional as tf

from ...framework.random import get_generator

__all__ = ["relu", "relu6", "relu_", "elu", "selu", "celu", "gelu",
           "leaky_relu", "prelu", "rrelu", "sigmoid", "hardsigmoid",
           "hardswish", "hardtanh", "hardshrink", "softshrink", "softsign",
           "softplus", "swish", "silu", "mish", "tanh", "tanhshrink",
           "thresholded_relu", "log_sigmoid", "maxout", "softmax",
           "log_softmax", "glu", "gumbel_softmax", "elu_", "softmax_",
           "tanh_"]


def _clip(x, lo, hi):
    """``jnp.clip``: a bound's gradient, where ``x`` equals it, is half
    the cotangent (``maximum``/``minimum`` split ties), where ``clamp``
    passes it whole; a ReLU6 after a zero-padded depthwise window meets
    exact zeros."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))


def relu(x, name=None):
    return torch.relu(x)


def relu6(x, name=None):
    return _clip(x, 0.0, 6.0)


def relu_(x):
    return torch.relu(x)


def elu(x, alpha=1.0, name=None):
    return tf.elu(x, alpha=alpha)


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0, name=None):
    return tf.celu(x, alpha=alpha)


def gelu(x, approximate=False, name=None):
    """approximate=True is the tanh form, as ``jax.nn.gelu`` has it."""
    return tf.gelu(x, approximate="tanh" if approximate else "none")


def leaky_relu(x, negative_slope=0.01, name=None):
    return tf.leaky_relu(x, negative_slope)


def prelu(x, weight, data_format="NCHW", name=None):
    w = weight
    if w.numel() > 1 and x.dim() > 1:
        ch_axis = 1 if data_format[1] == "C" else x.dim() - 1
        shape = [1] * x.dim()
        shape[ch_axis] = w.numel()
        w = w.reshape(shape)
    return torch.where(x > 0, x, w * x)


def rrelu(x, lower=0.125, upper=1.0 / 3.0, training=False, name=None):
    if training:
        u = torch.rand(x.shape, generator=get_generator(x.device),
                       device=x.device)
        slope = (lower + u * (upper - lower)).to(x.dtype)
    else:
        slope = (lower + upper) / 2.0
    return torch.where(x >= 0, x, slope * x)


def sigmoid(x, name=None):
    return torch.sigmoid(x)


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return _clip(slope * x + offset, 0.0, 1.0)


def hardswish(x, name=None):
    return x * _clip(x + 3.0, 0.0, 6.0) / 6.0


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return _clip(x, min, max)


def hardshrink(x, threshold=0.5, name=None):
    return torch.where(x.abs() > threshold, x, torch.zeros_like(x))


def softshrink(x, threshold=0.5, name=None):
    return torch.sign(x) * torch.clamp(x.abs() - threshold, min=0.0)


def softsign(x, name=None):
    return x / (x.abs() + 1)


def softplus(x, beta=1.0, threshold=20.0, name=None):
    scaled = beta * x
    return torch.where(scaled > threshold, x,
                       torch.log1p(torch.exp(scaled)) / beta)


def swish(x, name=None):
    return tf.silu(x)


silu = swish


def mish(x, name=None):
    return x * torch.tanh(softplus(x))


def tanh(x, name=None):
    return torch.tanh(x)


def tanhshrink(x, name=None):
    return x - torch.tanh(x)


def thresholded_relu(x, threshold=1.0, name=None):
    return torch.where(x > threshold, x, torch.zeros_like(x))


def log_sigmoid(x, name=None):
    return tf.logsigmoid(x)


def maxout(x, groups, axis=1, name=None):
    axis = axis % x.dim()
    c = x.shape[axis]
    shape = x.shape[:axis] + (c // groups, groups) + x.shape[axis + 1:]
    return torch.amax(x.reshape(shape), dim=axis + 1)


def softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        x = x.to(dtype)
    return torch.softmax(x, dim=axis)


def log_softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        x = x.to(dtype)
    return torch.log_softmax(x, dim=axis)


def glu(x, axis=-1, name=None):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    u = torch.rand(x.shape, generator=get_generator(x.device),
                   device=x.device).clamp(min=torch.finfo(torch.float32).tiny)
    g = (-torch.log(-torch.log(u))).to(x.dtype)
    y = torch.softmax((x + g) / temperature, dim=axis)
    if hard:
        idx = torch.argmax(y, dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter_(axis, idx, 1.0)
        y = (y_hard - y).detach() + y
    return y


def elu_(x, alpha=1.0):
    return elu(x, alpha)


def softmax_(x, axis=-1, dtype=None):
    return softmax(x, axis=axis, dtype=dtype)


def tanh_(x):
    return tanh(x)
