"""``linear``, ``dropout`` and ``embedding``.

Port of the three of ``paddle_tpu/nn/functional/common.py`` on the GPT
path. ``linear`` keeps the reference's ``(in, out)`` weight layout:
``x @ W + b``, never ``torch.nn.functional.linear``, and casts through
``amp.cast_if_amp`` as the reference's does. ``dropout`` draws its
keep mask on the generator of the tensor's device
(``framework.random``).
"""
from __future__ import annotations

import torch

from ...amp import cast_if_amp
from ...framework.random import get_generator

__all__ = ["linear", "dropout", "embedding"]


def linear(x, weight, bias=None, name=None):
    """y = x @ W + b, weight (in_features, out_features). Under
    ``amp.auto_cast`` x and W are cast to the amp dtype first."""
    x, weight = cast_if_amp("linear", x, weight)
    out = torch.matmul(x, weight)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    if not training or p == 0.0:
        return x if mode == "upscale_in_train" else x * (1.0 - p)
    if p == 1.0:
        return torch.zeros_like(x)
    shape = list(x.shape)
    if axis is not None:
        axes = (axis,) if isinstance(axis, int) else tuple(axis)
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    keep = torch.rand(shape, generator=get_generator(x.device),
                      device=x.device) >= p
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), torch.zeros_like(x)).to(x.dtype)
    return torch.where(keep, x, torch.zeros_like(x))


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` at the integer ids ``x``; ``padding_idx`` rows
    read as zeros."""
    out = weight[x.long()]
    if padding_idx is not None:
        out = out * (x != padding_idx)[..., None].to(out.dtype)
    return out
