"""Dtype registry: Paddle's dtype names as ``torch.dtype``s.

Port of ``paddle_tpu/framework/dtype.py``. The reference maps the names
(``"float32"``, ``"bfloat16"`` ...) onto ``jnp`` dtypes; the port maps
them onto ``torch`` dtypes and keeps the default floating dtype that
parameter creation and the tensor API's factories read.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["bool_", "uint8", "int8", "int16", "int32", "int64", "float16",
           "bfloat16", "float32", "float64", "complex64", "complex128",
           "set_default_dtype", "get_default_dtype", "convert_dtype",
           "is_floating", "is_integer"]

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_STR2DTYPE = {
    "bool": bool_, "uint8": uint8, "int8": int8, "int16": int16,
    "int32": int32, "int64": int64, "float16": float16,
    "bfloat16": bfloat16, "float32": float32, "float64": float64,
    "complex64": complex64, "complex128": complex128,
}

_default_dtype = torch.float32


def set_default_dtype(d):
    """Set the default floating dtype of parameter creation and of the
    tensor API's floating factories."""
    global _default_dtype
    _default_dtype = convert_dtype(d)


def get_default_dtype() -> torch.dtype:
    return _default_dtype


def convert_dtype(dtype):
    """A ``torch.dtype`` for a name, a numpy dtype or a torch dtype; None
    stays None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        if dtype not in _STR2DTYPE:
            raise ValueError(f"Unknown dtype string: {dtype!r}")
        return _STR2DTYPE[dtype]
    if dtype is bool:
        return bool_
    if dtype is int:
        return int64
    if dtype is float:
        return float32
    name = np.dtype(dtype).name
    if name not in _STR2DTYPE:
        raise ValueError(f"Unknown dtype: {dtype!r}")
    return _STR2DTYPE[name]


def is_floating(dtype) -> bool:
    return convert_dtype(dtype).is_floating_point


def is_integer(dtype) -> bool:
    d = convert_dtype(dtype)
    return not d.is_floating_point and not d.is_complex and d != torch.bool
