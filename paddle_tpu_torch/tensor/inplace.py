"""Trailing-underscore ("inplace") op variants.

Port of ``paddle_tpu/tensor/inplace.py``. The reference's arrays are
immutable, so its variants return the result; a ``torch.Tensor`` is
not, so the port's write into ``x`` as Paddle's do, and return ``x``.
The shape-changing ones (``reshape_``, ``flatten_``, ``squeeze_``,
``unsqueeze_``) change ``x``'s view of its storage.
"""
from __future__ import annotations

import torch

from . import manipulation as _manip
from . import math as _math

__all__ = [
    "add_", "subtract_", "ceil_", "clip_", "exp_", "flatten_", "floor_",
    "reciprocal_", "reshape_", "round_", "rsqrt_", "scale_", "scatter_",
    "sqrt_", "squeeze_", "tanh_", "unsqueeze_", "zero_", "fill_",
]


def _restride(x, like):
    """Make ``x`` the view ``like`` of its own storage."""
    with torch.no_grad():
        return x.set_(x.untyped_storage(), like.storage_offset(),
                      like.shape, like.stride())


def add_(x, y, name=None):
    return x.add_(y)


def subtract_(x, y, name=None):
    return x.sub_(y)


def ceil_(x, name=None):
    return x.ceil_()


def clip_(x, min=None, max=None, name=None):
    if min is None and max is None:
        return x
    return x.clamp_(min, max)


def exp_(x, name=None):
    return x.exp_()


def flatten_(x, start_axis=0, stop_axis=-1, name=None):
    return _restride(x, _manip.flatten(x, start_axis, stop_axis))


def floor_(x, name=None):
    return x.floor_()


def reciprocal_(x, name=None):
    return x.reciprocal_()


def reshape_(x, shape, name=None):
    return _restride(x, _manip.reshape(x, shape))


def round_(x, name=None):
    return x.round_()


def rsqrt_(x, name=None):
    return x.rsqrt_()


def scale_(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
           name=None):
    return x.copy_(_math.scale(x, scale=scale, bias=bias,
                               bias_after_scale=bias_after_scale, act=act))


def scatter_(x, index, updates, overwrite=True, name=None):
    return x.copy_(_manip.scatter(x, index, updates, overwrite=overwrite))


def sqrt_(x, name=None):
    return x.sqrt_()


def squeeze_(x, axis=None, name=None):
    return _restride(x, _manip.squeeze(x, axis))


def tanh_(x, name=None):
    return x.tanh_()


def unsqueeze_(x, axis, name=None):
    return _restride(x, _manip.unsqueeze(x, axis))


def zero_(x, name=None):
    return x.zero_()


def fill_(x, value, name=None):
    return x.fill_(value)
