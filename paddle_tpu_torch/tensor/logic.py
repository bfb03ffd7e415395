"""Comparison and logical ops (reference: python/paddle/tensor/logic.py).

Port of ``paddle_tpu/tensor/logic.py``; the whole-tensor predicates
(``allclose``, ``equal_all``, ``is_empty``) return 0-d bool tensors, as
the reference's do.
"""
from __future__ import annotations

import torch

__all__ = ["equal", "not_equal", "greater_than", "greater_equal",
           "less_than", "less_equal", "logical_and", "logical_or",
           "logical_xor", "logical_not", "bitwise_and", "bitwise_or",
           "bitwise_xor", "bitwise_not", "allclose", "isclose", "equal_all",
           "is_empty", "is_tensor"]


def equal(x, y, name=None):
    return torch.eq(x, y)


def not_equal(x, y, name=None):
    return torch.ne(x, y)


def greater_than(x, y, name=None):
    return torch.gt(x, y)


def greater_equal(x, y, name=None):
    return torch.ge(x, y)


def less_than(x, y, name=None):
    return torch.lt(x, y)


def less_equal(x, y, name=None):
    return torch.le(x, y)


def logical_and(x, y, out=None, name=None):
    return torch.logical_and(x, y)


def logical_or(x, y, out=None, name=None):
    return torch.logical_or(x, y)


def logical_xor(x, y, out=None, name=None):
    return torch.logical_xor(x, y)


def logical_not(x, out=None, name=None):
    return torch.logical_not(x)


def bitwise_and(x, y, out=None, name=None):
    return torch.bitwise_and(x, y)


def bitwise_or(x, y, out=None, name=None):
    return torch.bitwise_or(x, y)


def bitwise_xor(x, y, out=None, name=None):
    return torch.bitwise_xor(x, y)


def bitwise_not(x, out=None, name=None):
    return torch.bitwise_not(x)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return torch.all(torch.isclose(x, y, rtol=rtol, atol=atol,
                                   equal_nan=equal_nan))


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return torch.isclose(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan)


def equal_all(x, y, name=None):
    same = x.shape == y.shape and bool(torch.equal(x, y.to(x.dtype)))
    return torch.tensor(same, device=x.device)


def is_empty(x, name=None):
    return torch.tensor(x.numel() == 0, device=x.device)


def is_tensor(x):
    return isinstance(x, torch.Tensor)
