"""Layer: the module base class, an ``nn.Module``.

Port of ``paddle_tpu/nn/layer.py``. PyTorch's module system already has
what the reference builds by hand (parameters, sublayers, buffers,
``train``/``eval``, ``state_dict``), so ``Layer`` adds only:

- ``create_parameter(shape, dtype, initializer, is_bias)`` with the
  reference's defaults (``Constant(0)`` for biases, ``XavierUniform`` for
  weights);
- ``set_state_dict_from_numpy(state)``: loads the reference's
  ``{structured_name: array}`` (``paddle_tpu.nn.Layer.state_dict()``) 1:1.
  Name sets must be equal and shapes equal, else it raises.

Names are the reference's: the module tree is built in the same order,
``Linear.weight`` keeps the reference's ``(in, out)`` layout, and a tied
weight (the GPT head's) is registered once, under its owner's name, as the
reference's ``named_parameters`` dedupes by identity. ``bfloat16()`` and
``float()`` are ``nn.Module``'s: they cast every floating parameter and
buffer in place and keep no master copy, as the reference's ``astype``.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

__all__ = ["Layer"]


def _as_tensor(value) -> torch.Tensor:
    arr = np.asarray(value)
    if arr.dtype.kind not in "fiub" or arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)   # bfloat16 arrives as an ml_dtypes type
    return torch.from_numpy(np.array(arr, copy=True))


class Layer(nn.Module):
    """Base class of the port's modules (reference: nn/layer.py Layer)."""

    def create_parameter(self, shape, dtype=None, initializer=None,
                         is_bias: bool = False) -> nn.Parameter:
        from .initializer import Constant, XavierUniform
        dtype = dtype or torch.get_default_dtype()
        if initializer is None:
            initializer = Constant(0.0) if is_bias else XavierUniform()
        return nn.Parameter(initializer(tuple(shape), dtype))

    def named_state(self) -> Dict[str, torch.Tensor]:
        """Parameters (each once) then persistent buffers, by structured
        name: the reference's ``state_dict`` keys and order."""
        out = OrderedDict(self.named_parameters())
        out.update(self.state_dict(keep_vars=True))
        return out

    @torch.no_grad()
    def set_state_dict_from_numpy(self, state: Mapping[str, object]):
        """Copy the reference's ``{name: array}`` into this layer's
        parameters and buffers, keeping each one's dtype and device."""
        own = self.named_state()
        missing = sorted(set(own) - set(state))
        unexpected = sorted(set(state) - set(own))
        if missing or unexpected:
            raise ValueError(f"state names differ: missing {missing}, "
                             f"unexpected {unexpected}")
        for name, t in own.items():
            v = _as_tensor(state[name])
            if tuple(v.shape) != tuple(t.shape):
                raise ValueError(f"shape mismatch for {name}: got "
                                 f"{tuple(v.shape)}, expected "
                                 f"{tuple(t.shape)}")
            t.copy_(v.to(dtype=t.dtype))
        return self
