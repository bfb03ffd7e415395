"""The common functionals: ``linear``, the dropouts, ``embedding``,
``pad``, ``interpolate``/``upsample``, ``one_hot``, ``label_smooth``,
``fold``/``unfold``, ``cosine_similarity``, ``bilinear``,
``sequence_mask`` and ``class_center_sample``.

Port of ``paddle_tpu/nn/functional/common.py``. ``linear`` keeps the
reference's ``(in, out)`` weight layout: ``x @ W + b``, never
``torch.nn.functional.linear``, and casts through ``amp.cast_if_amp`` as
the reference's does. The dropouts draw their keep masks on the
generator of the tensor's device (``framework.random``).
"""
from __future__ import annotations

import numpy as np
import torch

from ...amp import cast_if_amp
from ...framework.random import get_generator

__all__ = ["linear", "dropout", "dropout2d", "dropout3d", "alpha_dropout",
           "embedding", "one_hot", "pad", "cosine_similarity",
           "label_smooth", "bilinear", "interpolate", "upsample", "unfold",
           "fold", "class_center_sample", "sequence_mask"]


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


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    """Whole channels dropped: one draw per (sample, channel)."""
    axis = (0, 1) if data_format == "NCHW" else (0, 3)
    return dropout(x, p=p, axis=axis, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    axis = (0, 1) if data_format == "NCDHW" else (0, 4)
    return dropout(x, p=p, axis=axis, training=training)


def alpha_dropout(x, p=0.5, training=True, name=None):
    """SELU's dropout: dropped units take the saturation value, then an
    affine map keeps the mean and variance."""
    if not training or p == 0.0:
        return x
    alpha = 1.6732632423543772
    scale = 1.0507009873554805
    alpha_p = -alpha * scale
    a = ((1.0 - p) * (1.0 + p * alpha_p ** 2)) ** -0.5
    b = -a * alpha_p * p
    keep = torch.rand(x.shape, generator=get_generator(x.device),
                      device=x.device) >= p
    return (a * torch.where(keep, x, torch.full_like(x, alpha_p))
            + b).to(x.dtype)


def one_hot(x, num_classes, name=None):
    """float32 one-hot rows; an id outside [0, num_classes) is a zero
    row, as ``jax.nn.one_hot`` gives."""
    classes = torch.arange(num_classes, device=x.device)
    return (x.long()[..., None] == classes).float()


def _pad_config(ndim, pad, data_format):
    """((lo, hi) per axis): a list of 2 * ndim pads is per axis in
    order; a shorter one pads the spatial axes, last axis first."""
    pad = [int(v) for v in (pad.tolist() if isinstance(pad, torch.Tensor)
                            else pad)]
    if len(pad) == 2 * ndim:
        return [(pad[2 * i], pad[2 * i + 1]) for i in range(ndim)]
    n_spatial = len(pad) // 2
    cfg = [(0, 0)] * ndim
    spatial = (list(range(1, 1 + n_spatial)) if data_format[-1] == "C"
               else list(range(ndim - n_spatial, ndim)))
    for i, ax in enumerate(reversed(spatial)):
        cfg[ax] = (pad[2 * i], pad[2 * i + 1])
    return cfg


def _pad_index(n, lo, hi, mode, device):
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "replicate":
        return i.clamp(0, n - 1)
    if mode == "circular":
        return i % n
    # reflect about the edge elements, as numpy's "reflect"
    period = 2 * (n - 1) if n > 1 else 1
    i = i.abs() % period
    return torch.where(i > n - 1, period - i, i)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """``mode``: constant (``value``), reflect, replicate or circular."""
    cfg = _pad_config(x.dim(), pad, data_format)
    if mode == "constant":
        flat = [v for lo_hi in reversed(cfg) for v in lo_hi]
        return torch.nn.functional.pad(x, flat, mode="constant", value=value)
    if mode not in ("reflect", "replicate", "circular"):
        raise ValueError(f"pad: unknown mode {mode!r}")
    for ax, (lo, hi) in enumerate(cfg):
        if lo or hi:
            x = x.index_select(ax, _pad_index(x.shape[ax], lo, hi, mode,
                                              x.device))
    return x


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    dot = (x1 * x2).sum(dim=axis)
    n1 = torch.sqrt((x1 * x1).sum(dim=axis))
    n2 = torch.sqrt((x2 * x2).sum(dim=axis))
    return dot / torch.clamp(n1 * n2, min=eps)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    """``(1 - epsilon) * label + epsilon / K`` over the last axis's K
    classes, or ``+ epsilon * prior_dist``."""
    if prior_dist is not None:
        return (1.0 - epsilon) * label + epsilon * prior_dist
    return (1.0 - epsilon) * label + epsilon / label.shape[-1]


def bilinear(x1, x2, weight, bias=None, name=None):
    """``out[b, o] = x1[b] @ weight[o] @ x2[b] + bias[o]``; weight
    (out_features, in1, in2)."""
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    if bias is not None:
        out = out + bias
    return out


def _keys_cubic(x):
    x = x.abs()
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x):
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _resize_weights(n_in, n_out, kernel, device):
    """(n_in, n_out) weights of ``jax.image.resize`` along one axis: half
    pixel centres, the kernel widened by the downscale factor
    (antialiasing), columns normalized, samples outside the input zero."""
    scale = n_out / n_in
    inv = 1.0 / scale
    kscale = max(inv, 1.0)
    f = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) \
        * inv - 0.5
    x = (f[None, :] - torch.arange(n_in, dtype=torch.float32,
                                   device=device)[:, None]).abs() / kscale
    w = kernel(x)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total,
                                    torch.ones_like(total)),
                    torch.zeros_like(w))
    ok = (f >= -0.5) & (f <= n_in - 0.5)
    return torch.where(ok[None, :], w, torch.zeros_like(w))


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Resize the spatial axes. ``nearest`` takes index ``floor(o * in /
    out)``; the linear modes (``linear``, ``bilinear``, ``trilinear``,
    ``area``) and ``bicubic`` with ``align_corners`` interpolate linearly
    between the corner-aligned neighbours; without it they are
    ``jax.image.resize``'s linear (triangle) and cubic (Keys, a = -0.5)
    kernels with half-pixel centres and antialiasing when shrinking, as
    the reference computes them. ``align_mode`` is accepted and unused,
    as in the reference."""
    n_spatial = x.dim() - 2
    spatial = (list(range(1, 1 + n_spatial)) if data_format[-1] == "C"
               else list(range(2, x.dim())))
    in_sizes = [x.shape[a] for a in spatial]
    if size is None:
        if scale_factor is None:
            raise ValueError("one of size/scale_factor required")
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) \
            else [scale_factor] * n_spatial
        size = [int(i * s) for i, s in zip(in_sizes, sf)]
    size = [int(s) for s in (size if isinstance(size, (list, tuple))
                             else [size] * n_spatial)]
    kernels = {"bilinear": _triangle, "linear": _triangle,
               "trilinear": _triangle, "area": _triangle,
               "bicubic": _keys_cubic}
    if mode != "nearest" and mode not in kernels:
        raise ValueError(f"interpolate: unknown mode {mode!r}")
    out = x
    for ax, i, o in zip(spatial, in_sizes, size):
        if mode == "nearest":
            idx = torch.floor(torch.arange(o, dtype=torch.float32,
                                           device=x.device) * (i / o)).long()
            out = out.index_select(ax, idx)
        elif align_corners:
            if o == 1 or i == 1:
                coords = torch.zeros(o, device=x.device)
            else:
                coords = torch.arange(o, dtype=torch.float32,
                                      device=x.device) * ((i - 1) / (o - 1))
            lo = torch.floor(coords).long()
            hi = (lo + 1).clamp(0, i - 1)
            shape = [1] * x.dim()
            shape[ax] = o
            w = (coords - lo).to(x.dtype).reshape(shape)
            a, b = out.index_select(ax, lo), out.index_select(ax, hi)
            out = a * (1 - w) + b * w
        else:
            w = _resize_weights(i, o, kernels[mode], x.device).to(x.dtype)
            out = torch.movedim(torch.tensordot(out, w, dims=([ax], [0])),
                                -1, ax)
    return out


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: (N, C, H, W) -> (N, C * kh * kw, L), rows channel-major."""
    return torch.nn.functional.unfold(
        x, _pair(kernel_sizes), dilation=_pair(dilations),
        padding=_pair(paddings), stride=_pair(strides))


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im: the patches of :func:`unfold` summed back into (N, C,
    *output_sizes)."""
    return torch.nn.functional.fold(
        x, _pair(output_sizes), _pair(kernel_sizes),
        dilation=_pair(dilations), padding=_pair(paddings),
        stride=_pair(strides))


def class_center_sample(label, num_classes, num_samples, group=None):
    """PartialFC's class-centre sampling: every class present in
    ``label`` is kept, the other ``num_samples`` slots take random
    negative classes (from the port's generator of the label's device),
    and labels are remapped into the sampled index space -> (remapped
    label, sampled classes (num_samples,)). A label whose class was not
    sampled (more positives than ``num_samples``) maps to -1."""
    if num_samples > num_classes:
        raise ValueError(
            f"class_center_sample: num_samples ({num_samples}) must be "
            f"<= num_classes ({num_classes})")
    label = torch.as_tensor(label).reshape(-1)
    if label.numel() and (int(label.min()) < 0 or
                          int(label.max()) >= num_classes):
        raise ValueError(
            f"class_center_sample: labels must be in [0, {num_classes})"
            f", got range [{int(label.min())}, {int(label.max())}]")
    dev = label.device
    present = torch.zeros(num_classes, dtype=torch.bool, device=dev)
    present[label.long()] = True
    rand = torch.rand(num_classes, generator=get_generator(dev), device=dev)
    score = torch.where(present, rand - 2.0, rand)
    sampled = torch.argsort(score)[:num_samples].to(label.dtype)
    inv = torch.full((num_classes,), -1, dtype=label.dtype, device=dev)
    inv[sampled.long()] = torch.arange(num_samples, dtype=label.dtype,
                                       device=dev)
    return inv[label.long()], sampled


def sequence_mask(lengths, maxlen=None, dtype="int64"):
    """``mask[..., j] = j < lengths[...]`` in ``dtype``."""
    from ...framework.dtype import convert_dtype
    lengths = torch.as_tensor(lengths)
    if maxlen is None:
        maxlen = int(lengths.max())
    row = torch.arange(int(maxlen), device=lengths.device)
    return (row < lengths[..., None]).to(convert_dtype(dtype))
