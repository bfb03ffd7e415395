"""Tensor creation ops (reference: python/paddle/tensor/creation.py).

Port of ``paddle_tpu/tensor/creation.py``. A Tensor is a
``torch.Tensor``. Like torch's own factories these make their tensor on
the CPU unless a device is given (``place=`` of ``to_tensor``) or it is
made from a tensor that lies elsewhere (``*_like``).
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..framework import dtype as dtype_mod
from ._util import as_tensor

__all__ = ["to_tensor", "zeros", "ones", "full", "empty", "zeros_like",
           "ones_like", "full_like", "empty_like", "arange", "linspace",
           "eye", "diag", "diagflat", "tril", "triu", "meshgrid", "assign",
           "clone", "numel", "shape", "tolist", "complex", "Tensor"]

Tensor = torch.Tensor


def _dt(dtype, default=True):
    d = dtype_mod.convert_dtype(dtype)
    return d if d is not None or not default else dtype_mod.get_default_dtype()


def _shape(shape):
    if isinstance(shape, torch.Tensor):
        return tuple(int(s) for s in shape.reshape(-1).tolist())
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s) for s in shape)


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    x = as_tensor(data if isinstance(data, torch.Tensor) else
                  np.asarray(data), dtype)
    if x.dtype == torch.float64 and dtype is None and \
            not isinstance(data, (torch.Tensor, np.ndarray)):
        x = x.to(dtype_mod.get_default_dtype())  # Python floats: float32
    if place is not None:
        x = x.to(place)
    if not stop_gradient:
        x = x.detach().requires_grad_(True)
    return x


def zeros(shape, dtype=None, name=None):
    return torch.zeros(_shape(shape), dtype=_dt(dtype))


def ones(shape, dtype=None, name=None):
    return torch.ones(_shape(shape), dtype=_dt(dtype))


def full(shape, fill_value, dtype=None, name=None):
    return torch.full(_shape(shape), fill_value, dtype=_dt(dtype, False))


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


def zeros_like(x, dtype=None, name=None):
    return torch.zeros_like(x, dtype=_dt(dtype, False))


def ones_like(x, dtype=None, name=None):
    return torch.ones_like(x, dtype=_dt(dtype, False))


def full_like(x, fill_value, dtype=None, name=None):
    return torch.full_like(x, fill_value, dtype=_dt(dtype, False))


def empty_like(x, dtype=None, name=None):
    return torch.zeros_like(x, dtype=_dt(dtype, False))


def arange(start=0, end=None, step=1, dtype=None, name=None):
    if end is None:
        start, end = 0, start
    return torch.arange(start, end, step, dtype=_dt(dtype, False))


def linspace(start, stop, num, dtype=None, name=None):
    return torch.linspace(float(start), float(stop), int(num),
                          dtype=_dt(dtype))


def eye(num_rows, num_columns=None, dtype=None, name=None):
    return torch.eye(num_rows, num_rows if num_columns is None
                     else num_columns, dtype=_dt(dtype))


def diag(x, offset=0, padding_value=0, name=None):
    x = as_tensor(x)
    if x.ndim == 1 and padding_value != 0:
        n = x.shape[0] + builtins.abs(offset)
        base = torch.full((n, n), padding_value, dtype=x.dtype,
                          device=x.device)
        return base + torch.diag(x - padding_value, offset)
    return torch.diag(x, offset)


def diagflat(x, offset=0, name=None):
    return torch.diagflat(x, offset)


def tril(x, diagonal=0, name=None):
    return torch.tril(x, diagonal)


def triu(x, diagonal=0, name=None):
    return torch.triu(x, diagonal)


def meshgrid(*args, **kwargs):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    return list(torch.meshgrid(*args, indexing="ij"))


def assign(x, output=None):
    out = as_tensor(x if isinstance(x, torch.Tensor) else np.asarray(x))
    if output is not None:
        output.copy_(out)
        return output
    return out


def clone(x, name=None):
    return x.clone()


def numel(x, name=None):
    return torch.tensor(x.numel(), dtype=torch.int32, device=x.device)


def shape(x):
    return torch.tensor(list(x.shape), dtype=torch.int32)


def tolist(x):
    return x.tolist()


def complex(real, imag, name=None):
    return torch.complex(real, imag)
