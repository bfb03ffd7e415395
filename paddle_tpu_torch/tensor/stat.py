"""Statistics ops (reference: python/paddle/tensor/stat.py).

Port of ``paddle_tpu/tensor/stat.py``. The quantiles follow
``jnp.quantile``'s linear interpolation (torch's ``median`` takes the
lower middle value and its ``quantile`` interpolates infinities to NaN),
and the medians are quantiles at 0.5.
"""
from __future__ import annotations

import torch

from ..framework import dtype as dtype_mod
from ._util import dims, float_of

__all__ = ["mean", "std", "var", "median", "nanmedian", "quantile",
           "nanquantile", "nansum", "nanmean", "numel"]


def mean(x, axis=None, keepdim=False, name=None):
    x = float_of(x)
    return torch.mean(x, dim=dims(x, axis), keepdim=keepdim)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    x = float_of(x)
    return torch.std(x, dim=dims(x, axis), correction=1 if unbiased else 0,
                     keepdim=keepdim)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    x = float_of(x)
    return torch.var(x, dim=dims(x, axis), correction=1 if unbiased else 0,
                     keepdim=keepdim)


def _quantile(x, q, axis, keepdim, skip_nan):
    """``jnp.quantile``'s linear method: ``lo * (1 - w) + hi * w`` between
    the two order statistics around ``q * (n - 1)``; a NaN in a row makes
    its result NaN, unless ``skip_nan`` (then n counts the others)."""
    x = float_of(x)
    qt = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    d = dims(x, axis)
    keep = [i for i in range(x.ndim) if i not in d]
    moved = x.permute(keep + list(d))
    flat = moved.reshape(tuple(moved.shape[:len(keep)]) + (-1,))
    nan = torch.isnan(flat)
    srt = torch.sort(flat, dim=-1).values          # NaNs last
    if skip_nan:
        n = (~nan).sum(-1, keepdim=True)
    else:
        n = torch.full(flat.shape[:-1] + (1,), flat.shape[-1],
                       device=x.device)
    outs = []
    for qv in qt.reshape(-1):
        pos = qv * (n - 1).to(x.dtype)
        lo = torch.clamp(torch.floor(pos), min=0)
        hi = torch.clamp(torch.ceil(pos), min=0)
        w = pos - lo
        lo_v = torch.gather(srt, -1, lo.long())
        hi_v = torch.gather(srt, -1, hi.long())
        res = (lo_v * (1 - w) + hi_v * w).squeeze(-1)
        bad = (n.squeeze(-1) == 0) if skip_nan else nan.any(-1)
        res = torch.where(bad, torch.full_like(res, float("nan")), res)
        if keepdim:
            shape = list(x.shape)
            for i in d:
                shape[i] = 1
            res = res.reshape(shape)
        outs.append(res)
    return torch.stack(outs) if qt.ndim else outs[0]


def median(x, axis=None, keepdim=False, name=None):
    return _quantile(x, 0.5, axis, keepdim, False)


def nanmedian(x, axis=None, keepdim=False, name=None):
    return _quantile(x, 0.5, axis, keepdim, True)


def quantile(x, q, axis=None, keepdim=False, name=None):
    return _quantile(x, q, axis, keepdim, False)


def nanquantile(x, q, axis=None, keepdim=False, name=None):
    return _quantile(x, q, axis, keepdim, True)


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    return torch.nansum(x, dim=dims(x, axis), keepdim=keepdim,
                        dtype=dtype_mod.convert_dtype(dtype))


def nanmean(x, axis=None, keepdim=False, name=None):
    return torch.nanmean(float_of(x), dim=dims(x, axis), keepdim=keepdim)


def numel(x, name=None):
    return torch.tensor(x.numel(), dtype=torch.int32, device=x.device)
