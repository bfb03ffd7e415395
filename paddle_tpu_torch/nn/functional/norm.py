"""Normalization functionals (port of ``paddle_tpu/nn/functional/norm.py``,
whole): ``batch_norm``, ``layer_norm``, ``instance_norm``, ``group_norm``,
``normalize`` and ``local_response_norm``.

In ``layer_norm`` the reference normalizes in float32, casts the
normalized value to x's dtype, and only then multiplies by the weight and
adds the bias, in that dtype. ``torch.nn.functional.layer_norm`` applies
the affine part before the cast, so the port writes the reference's order
out. ``batch_norm`` keeps Paddle's conventions (its docstring), which are
not ``torch.nn.functional.batch_norm``'s.
"""
from __future__ import annotations

import torch

__all__ = ["batch_norm", "layer_norm", "instance_norm", "group_norm",
           "normalize", "local_response_norm"]


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


def _channel_shape(x, axis):
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    return shape


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5, data_format="NCHW",
               use_global_stats=None, name=None):
    """The reference's batch norm: ``(out, new_mean, new_var)`` in training
    (the stats as the functional's results, never written here), else
    ``out``. Paddle's conventions, not ``torch.nn.functional.batch_norm``'s:
    ``new = momentum·old + (1 - momentum)·batch``, the biased batch
    variance, ``rsqrt`` taken in float32 and cast to x's dtype, and the
    arithmetic in the dtypes the operands give it (a float32 stat against
    bfloat16 x promotes, as jnp does)."""
    axis = x.dim() - 1 if data_format[-1] == "C" else 1
    dims = tuple(i for i in range(x.dim()) if i != axis)
    if training and not use_global_stats:
        var, mean = torch.var_mean(x, dim=dims, correction=0)
        new_rm = momentum * running_mean + (1.0 - momentum) * mean
        new_rv = momentum * running_var + (1.0 - momentum) * var
    else:
        mean, var = running_mean, running_var
        new_rm, new_rv = running_mean, running_var
    shape = _channel_shape(x, axis)
    inv = torch.rsqrt(var.float() + epsilon).to(x.dtype)
    out = (x - mean.reshape(shape)) * inv.reshape(shape)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    if training:
        return out, new_rm, new_rv
    return out


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    """Per-sample, per-channel statistics over the spatial dims, in x's
    dtype; the running stats are accepted and unused, as the reference's."""
    axis = x.dim() - 1 if data_format[-1] == "C" else 1
    spatial = (tuple(range(2, x.dim())) if axis == 1
               else tuple(range(1, x.dim() - 1)))
    var, mean = torch.var_mean(x, dim=spatial, correction=0, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + eps)
    shape = _channel_shape(x, axis)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    channel_last = data_format[-1] == "C"
    xc = x.movedim(-1, 1) if channel_last else x
    n, c = xc.shape[0], xc.shape[1]
    grouped = xc.reshape((n, num_groups, c // num_groups) + xc.shape[2:])
    var, mean = torch.var_mean(grouped, dim=tuple(range(2, grouped.dim())),
                               correction=0, keepdim=True)
    out = ((grouped - mean) * torch.rsqrt(var + epsilon)).reshape(xc.shape)
    shape = [1, c] + [1] * (xc.dim() - 2)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out.movedim(1, -1) if channel_last else out


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    if p == 2:
        norm = torch.sqrt(torch.sum(x.square(), dim=axis, keepdim=True))
    else:
        norm = torch.sum(x.abs() ** p, dim=axis, keepdim=True) ** (1.0 / p)
    return x / torch.clamp(norm, min=epsilon)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """x / (k + alpha · the sum of x² over ``size`` channels around each
    one, zero-padded ``size//2`` before and ``size-1-size//2`` after)**beta."""
    axis = x.dim() - 1 if data_format[-1] == "C" else 1
    half = size // 2
    sq = x.square().movedim(axis, -1)
    acc = torch.nn.functional.pad(sq, (half, size - 1 - half)).unfold(
        -1, size, 1).sum(-1).movedim(-1, axis)
    return x / torch.pow(k + alpha * acc, beta)
