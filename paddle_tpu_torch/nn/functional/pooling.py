"""Pooling (port of ``paddle_tpu/nn/functional/pooling.py``, whole).

What the reference computes, kept as it is:

- the window is the kernel, the stride defaults to it, and the pads are
  the convolutions' forms; ``"SAME"`` pads ``((k-1)//2, k-1-(k-1)//2)``
  whatever the input size (the reference's rule for pooling, not lax's);
- ``ceil_mode`` and ``return_mask`` are accepted and ignored: the output
  size is the floor rule's, and ``max_pool*`` returns the values alone;
  ``divisor_override`` is ignored too;
- max pooling pads with -inf (the dtype's least value for integers);
  average pooling sums over zero padding and divides by the window's
  element count, or, when ``exclusive`` and some pad is not zero, by the
  count of real elements under each window;
- adaptive pooling reshapes and reduces when every input size divides by
  its output size, else reduces segment by segment along each axis, with
  segment i over ``[floor(i·in/out), ceil((i+1)·in/out))``; the 1-D forms
  and ``adaptive_max_pool2d/3d`` are channel-first only.

Channel-last data is moved to channel-first for the call and back.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as tf

from .conv import _channel_first, _resolve_padding, _torch_pad, _tuplize

__all__ = ["max_pool1d", "max_pool2d", "max_pool3d", "avg_pool1d",
           "avg_pool2d", "avg_pool3d", "adaptive_avg_pool1d",
           "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d",
           "adaptive_max_pool3d"]

_MAX = {1: tf.max_pool1d, 2: tf.max_pool2d, 3: tf.max_pool3d}


def _window(kernel, stride, padding, n):
    kernel = _tuplize(kernel, n)
    stride = _tuplize(stride if stride is not None else kernel, n)
    pads = _resolve_padding(padding, n)
    if pads == "SAME":
        pads = [((k - 1) // 2, k - 1 - (k - 1) // 2) for k in kernel]
    return kernel, stride, pads


def _window_sum(x, kernel, stride, n):
    """Sum over each window of channel-first ``x`` (no padding)."""
    if n == 1:
        return tf.avg_pool2d(x.unsqueeze(-2), (1,) + kernel, (1,) + stride,
                             divisor_override=1).squeeze(-2)
    pool = tf.avg_pool2d if n == 2 else tf.avg_pool3d
    return pool(x, kernel, stride, divisor_override=1)


def _max_pool(x, kernel, stride, padding, ceil_mode, n, data_format):
    channel_last = data_format[-1] == "C"
    kernel, stride, pads = _window(kernel, stride, padding, n)
    x = _channel_first(x, channel_last)
    low = (-math.inf if x.is_floating_point()
           else torch.iinfo(x.dtype).min)
    if any(p != (0, 0) for p in pads):
        x = tf.pad(x, _torch_pad(pads), value=low)
    if x.is_floating_point():
        out = _MAX[n](x, kernel, stride)
    else:
        out = x
        for i, (k, s) in enumerate(zip(kernel, stride)):
            out = out.unfold(2 + i, k, s)
        out = out.amax(dim=tuple(range(-n, 0)))
    return out.movedim(1, -1) if channel_last else out


def _avg_pool(x, kernel, stride, padding, ceil_mode, exclusive, n,
              data_format):
    channel_last = data_format[-1] == "C"
    kernel, stride, pads = _window(kernel, stride, padding, n)
    x = _channel_first(x, channel_last)
    padded = any(p != (0, 0) for p in pads)
    summed = _window_sum(tf.pad(x, _torch_pad(pads)) if padded else x,
                         kernel, stride, n)
    if exclusive and padded:
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        out = summed / _window_sum(tf.pad(ones, _torch_pad(pads)), kernel,
                                   stride, n)
    else:
        out = summed / float(math.prod(kernel))
    return out.movedim(1, -1) if channel_last else out


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    return _max_pool(x, kernel_size, stride, padding, ceil_mode, 1,
                     "NLC" if data_format[-1] == "C" else "NCW")


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    return _max_pool(x, kernel_size, stride, padding, ceil_mode, 2,
                     data_format)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    return _max_pool(x, kernel_size, stride, padding, ceil_mode, 3,
                     data_format)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _avg_pool(x, kernel_size, stride, padding, ceil_mode, exclusive, 1,
                     "NLC" if data_format[-1] == "C" else "NCW")


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _avg_pool(x, kernel_size, stride, padding, ceil_mode, exclusive, 2,
                     data_format)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _avg_pool(x, kernel_size, stride, padding, ceil_mode, exclusive, 3,
                     data_format)


def _adaptive_pool(x, output_size, n, data_format, op):
    channel_last = data_format[-1] == "C"
    out_sizes = _tuplize(output_size, n)
    axes = (tuple(range(1, 1 + n)) if channel_last
            else tuple(range(2, 2 + n)))
    in_sizes = [x.shape[a] for a in axes]
    if all(i % o == 0 for i, o in zip(in_sizes, out_sizes)):
        shape = list(x.shape)
        for a, o in zip(reversed(axes), reversed(out_sizes)):
            shape[a:a + 1] = [o, shape[a] // o]
        return op(x.reshape(shape), tuple(a + 1 + k for k, a in
                                          enumerate(axes)), False)
    y = x
    for a, o in zip(axes, out_sizes):
        size = y.shape[a]
        pieces = [op(y.narrow(a, (i * size) // o,
                              -(-((i + 1) * size) // o) - (i * size) // o),
                     (a,), True) for i in range(o)]
        y = torch.cat(pieces, dim=a)
    return y


def _mean(x, dims, keepdim):
    return x.mean(dim=dims, keepdim=keepdim)


def _amax(x, dims, keepdim):
    return x.amax(dim=dims, keepdim=keepdim)


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive_pool(x, output_size, 1, "NCW", _mean)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive_pool(x, output_size, 2, data_format, _mean)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive_pool(x, output_size, 3, data_format, _mean)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive_pool(x, output_size, 1, "NCW", _amax)


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive_pool(x, output_size, 2, "NCHW", _amax)


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive_pool(x, output_size, 3, "NCDHW", _amax)
