"""Helpers shared by the tensor API's modules."""
from __future__ import annotations

import torch

from ..framework import dtype as dtype_mod


def as_tensor(x, dtype=None) -> torch.Tensor:
    """``x`` as a tensor (numpy arrays, lists and scalars are converted on
    the CPU; a tensor stays where it is)."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype_mod.convert_dtype(dtype))
    return torch.as_tensor(x, dtype=dtype_mod.convert_dtype(dtype))


def dims(x, axis):
    """``axis`` (None, an int or a sequence) as a tuple of dims of ``x``."""
    if axis is None:
        return tuple(range(x.ndim))
    if isinstance(axis, int):
        return (axis % max(x.ndim, 1),)
    return tuple(int(a) % max(x.ndim, 1) for a in axis)


def reduce(fn, x, axis, keepdim):
    """Apply the one-dim reduction ``fn(x, dim, keepdim)`` over every dim of
    ``axis``, highest first, so that the dims left keep their numbers."""
    if x.ndim == 0:
        return fn(x.reshape(1), 0, False)
    for d in sorted(dims(x, axis), reverse=True):
        x = fn(x, d, keepdim)
    return x


def float_of(x: torch.Tensor) -> torch.Tensor:
    """``x``, or ``x`` in the default float dtype when it is not floating
    (``jnp.mean`` of integers gives a float)."""
    if x.is_floating_point() or x.is_complex():
        return x
    return x.to(dtype_mod.get_default_dtype())
