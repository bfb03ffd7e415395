"""TensorArray ops (reference: python/paddle/tensor/array.py —
create_array/array_read/array_write/array_length over LOD_TENSOR_ARRAY vars,
framework.proto VarType.LOD_TENSOR_ARRAY).

Translation: the reference's LoDTensorArray exists so the *static graph*
can hold a dynamically-growing list of tensors (while_loop bodies). In an
eager framework a Python list serves. Port of
``paddle_tpu/tensor/array.py``, unchanged: pure Python.
"""
from __future__ import annotations

__all__ = ["create_array", "array_read", "array_write", "array_length"]


class TensorArray(list):
    """A Python-list-backed tensor array (reference LoDTensorArray)."""


def create_array(dtype="float32", initialized_list=None):
    arr = TensorArray()
    if initialized_list is not None:
        arr.extend(initialized_list)
    return arr


def array_write(x, i, array=None):
    i = int(i)
    if array is None:
        array = create_array()
    while len(array) <= i:
        array.append(None)
    array[i] = x
    return array


def array_read(array, i):
    return array[int(i)]


def array_length(array):
    return len(array)
