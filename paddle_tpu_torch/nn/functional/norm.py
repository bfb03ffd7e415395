"""``layer_norm`` (port of ``paddle_tpu/nn/functional/norm.py``'s).

The reference normalizes in float32, casts the normalized value to x's
dtype, and only then multiplies by the weight and adds the bias, in that
dtype. ``torch.nn.functional.layer_norm`` applies the affine part before
the cast, so the port writes the reference's order out.
"""
from __future__ import annotations

import torch

__all__ = ["layer_norm"]


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    dims = tuple(range(x.dim() - len(normalized_shape), x.dim()))
    x32 = x.float()
    mean = x32.mean(dim=dims, keepdim=True)
    var = x32.var(dim=dims, keepdim=True, unbiased=False)
    out = ((x32 - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out
