"""Convolutions (port of ``paddle_tpu/nn/functional/conv.py``).

The reference computes every convolution with ``lax.conv_general_dilated``,
outside any Pallas kernel; the port calls ``torch.nn.functional.conv{n}d``
and ``conv_transpose{n}d`` (cuDNN on the card). What the port keeps of the
reference:

- the weight layout: ``(O, I/groups, *K)``, and ``(I, O/groups, *K)`` for
  the transposed convolutions (PyTorch's own layouts);
- every padding form: an int, one int a spatial dim, ``(lo, hi)`` pairs
  (flat or nested), ``"VALID"`` and ``"SAME"`` (lax's rule: output
  ``ceil(in / stride)``, the total pad split with the smaller half
  first). Asymmetric pads are applied with ``F.pad`` before a convolution
  with no padding of its own;
- channel-last data (``NLC``/``NWC``, ``NHWC``, ``NDHWC``): moved to
  channel-first for the call and back after it;
- the transposed convolution as the gradient of a convolution: the full
  ``conv_transpose`` output (no padding) cropped by ``(lo, hi)`` and
  extended by ``output_padding`` with zeros, which is what the
  reference's lhs-dilated convolution with pads ``(d·(k-1) - lo,
  d·(k-1) - hi + output_padding)`` computes; ``output_size`` only crops;
- ``amp.cast_if_amp(f"conv{n}d", x, weight)`` before a forward
  convolution (not before a transposed one, as in the reference), and the
  bias added after the convolution (cast to the output's dtype in the
  forward convolutions only).
"""
from __future__ import annotations

import torch
import torch.nn.functional as tf

from ...amp import cast_if_amp

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]

_CONV = {1: tf.conv1d, 2: tf.conv2d, 3: tf.conv3d}
_CONV_T = {1: tf.conv_transpose1d, 2: tf.conv_transpose2d,
           3: tf.conv_transpose3d}


def _tuplize(v, n):
    if isinstance(v, (int, float)):
        return (int(v),) * n
    v = tuple(int(x) for x in v)
    return v * n if len(v) == 1 else v


def _resolve_padding(padding, n):
    """The reference's padding forms -> ``"SAME"`` or n (lo, hi) pairs."""
    if isinstance(padding, str):
        p = padding.upper()
        if p == "VALID":
            return [(0, 0)] * n
        if p == "SAME":
            return "SAME"
        raise ValueError(f"bad padding {padding!r}")
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * n:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(n)]
    if all(isinstance(p, (list, tuple)) for p in padding):
        return [tuple(p) for p in padding]
    raise ValueError(f"bad padding {padding!r}")


def _same_pads(sizes, ksize, stride, dilation):
    """lax's SAME: output ceil(in / stride), the total pad split lo-first."""
    pads = []
    for i, k, s, d in zip(sizes, ksize, stride, dilation):
        out = -(-i // s)
        total = max((out - 1) * s + (k - 1) * d + 1 - i, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _torch_pad(pads):
    """(lo, hi) pairs in dim order -> ``F.pad``'s list (last dim first)."""
    out = []
    for lo, hi in reversed(pads):
        out += [lo, hi]
    return out


def _channel_first(x, channel_last):
    return x.movedim(-1, 1) if channel_last else x


def _add_bias(out, bias, n, cast):
    if bias is None:
        return out
    b = bias.reshape((1, -1) + (1,) * n)
    return out + (b.to(out.dtype) if cast else b)


def _conv_nd(x, weight, bias, stride, padding, dilation, groups, n,
             data_format):
    x, weight = cast_if_amp(f"conv{n}d", x, weight)
    channel_last = data_format[-1] == "C"
    stride = _tuplize(stride, n)
    dilation = _tuplize(dilation, n)
    ksize = tuple(weight.shape[2:])
    x = _channel_first(x, channel_last)
    pads = _resolve_padding(padding, n)
    if pads == "SAME":
        pads = _same_pads(x.shape[2:], ksize, stride, dilation)
    if all(lo == hi and lo >= 0 for lo, hi in pads):
        out = _CONV[n](x, weight, None, stride, [lo for lo, _ in pads],
                       dilation, groups)
    else:
        out = _CONV[n](tf.pad(x, _torch_pad(pads)), weight, None, stride, 0,
                       dilation, groups)
    out = _add_bias(out, bias, n, cast=True)
    return out.movedim(1, -1) if channel_last else out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 1,
                    "NLC" if data_format in ("NLC", "NWC") else "NCW")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 2,
                    data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 3,
                    data_format)


def _conv_transpose_nd(x, weight, bias, stride, padding, output_padding,
                       dilation, groups, n, data_format, output_size=None):
    channel_last = data_format[-1] == "C"
    stride = _tuplize(stride, n)
    dilation = _tuplize(dilation, n)
    ksize = tuple(weight.shape[2:])
    pads = _resolve_padding(padding, n)
    if pads == "SAME":
        pads = [((k - 1) // 2, k - 1 - (k - 1) // 2) for k in ksize]
    out_pad = _tuplize(output_padding if output_padding is not None else 0, n)
    x = _channel_first(x, channel_last)
    full = _CONV_T[n](x, weight, None, stride, 0, 0, groups, dilation)
    out = tf.pad(full, _torch_pad([(-lo, op - hi) for (lo, hi), op in
                                   zip(pads, out_pad)]))
    if output_size is not None:
        for i, target in enumerate(_tuplize(output_size, n)):
            out = out.narrow(2 + i, 0, min(target, out.shape[2 + i]))
    out = _add_bias(out, bias, n, cast=False)
    return out.movedim(1, -1) if channel_last else out


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, output_size=None,
                     data_format="NCL", name=None):
    return _conv_transpose_nd(
        x, weight, bias, stride, padding, output_padding, dilation, groups, 1,
        "NLC" if data_format in ("NLC", "NWC") else "NCW", output_size)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, output_size=None,
                     data_format="NCHW", name=None):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, 2,
                              data_format, output_size)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, output_size=None,
                     data_format="NCDHW", name=None):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, 3,
                              data_format, output_size)
