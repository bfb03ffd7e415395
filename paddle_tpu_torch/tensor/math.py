"""Elementwise, reduction and matmul ops.

Port of ``paddle_tpu/tensor/math.py`` (reference:
python/paddle/tensor/math.py). Each function is the ``torch`` op of the
same meaning; ``matmul`` keeps the reference's amp cast
(``amp.cast_if_amp("matmul", ...)``).
"""
from __future__ import annotations

import torch

from ..framework import dtype as dtype_mod
from ._util import dims, float_of, reduce

__all__ = [
    "add", "subtract", "multiply", "divide", "floor_divide", "remainder",
    "mod", "floor_mod", "pow", "maximum", "minimum", "fmax", "fmin", "atan2",
    "logaddexp", "inner", "outer", "sqrt", "rsqrt", "exp", "expm1", "log",
    "log2", "log10", "log1p", "abs", "ceil", "floor", "round", "trunc",
    "sin", "cos", "tan", "asin", "acos", "atan", "sinh", "cosh", "tanh",
    "asinh", "acosh", "atanh", "sigmoid", "square", "reciprocal", "sign",
    "neg", "erf", "erfinv", "digamma", "lgamma", "conj", "angle", "real",
    "imag", "frac", "rad2deg", "deg2rad", "isnan", "isinf", "isfinite",
    "clip", "lerp", "nan_to_num", "sum", "mean", "prod", "max", "min",
    "amax", "amin", "logsumexp", "all", "any", "cumsum", "cumprod",
    "count_nonzero", "trace", "diff", "kron", "matmul", "mm", "bmm", "dot",
    "mv", "addmm", "multiplex", "increment", "scale", "stanh",
    "broadcast_shape", "gcd", "lcm", "add_n", "diagonal",
]


# -- binary elementwise ----------------------------------------------------
def add(x, y, name=None):
    return torch.add(x, y)


def subtract(x, y, name=None):
    return torch.subtract(x, y)


def multiply(x, y, name=None):
    return torch.multiply(x, y)


def divide(x, y, name=None):
    return torch.divide(x, y)


def floor_divide(x, y, name=None):
    return torch.floor_divide(x, y)


def remainder(x, y, name=None):
    return torch.remainder(x, y)


mod = remainder
floor_mod = remainder


def pow(x, y, name=None):
    return torch.pow(x, y)


def maximum(x, y, name=None):
    return torch.maximum(x, y)


def minimum(x, y, name=None):
    return torch.minimum(x, y)


def fmax(x, y, name=None):
    return torch.fmax(x, y)


def fmin(x, y, name=None):
    return torch.fmin(x, y)


def atan2(x, y, name=None):
    return torch.atan2(x, y)


def logaddexp(x, y, name=None):
    return torch.logaddexp(x, y)


def inner(x, y, name=None):
    return torch.inner(x, y)


def outer(x, y, name=None):
    return torch.outer(x.reshape(-1), y.reshape(-1))


# -- unary elementwise -----------------------------------------------------
def sqrt(x, name=None):
    return torch.sqrt(x)


def rsqrt(x, name=None):
    return torch.rsqrt(x)


def exp(x, name=None):
    return torch.exp(x)


def expm1(x, name=None):
    return torch.expm1(x)


def log(x, name=None):
    return torch.log(x)


def log2(x, name=None):
    return torch.log2(x)


def log10(x, name=None):
    return torch.log10(x)


def log1p(x, name=None):
    return torch.log1p(x)


def abs(x, name=None):
    return torch.abs(x)


def ceil(x, name=None):
    return torch.ceil(x)


def floor(x, name=None):
    return torch.floor(x)


def round(x, name=None):
    return torch.round(x)


def trunc(x, name=None):
    return torch.trunc(x)


def sin(x, name=None):
    return torch.sin(x)


def cos(x, name=None):
    return torch.cos(x)


def tan(x, name=None):
    return torch.tan(x)


def asin(x, name=None):
    return torch.asin(x)


def acos(x, name=None):
    return torch.acos(x)


def atan(x, name=None):
    return torch.atan(x)


def sinh(x, name=None):
    return torch.sinh(x)


def cosh(x, name=None):
    return torch.cosh(x)


def tanh(x, name=None):
    return torch.tanh(x)


def asinh(x, name=None):
    return torch.asinh(x)


def acosh(x, name=None):
    return torch.acosh(x)


def atanh(x, name=None):
    return torch.atanh(x)


def sigmoid(x, name=None):
    return torch.sigmoid(x)


def square(x, name=None):
    return torch.square(x)


def reciprocal(x, name=None):
    return torch.reciprocal(x)


def sign(x, name=None):
    return torch.sign(x)


def neg(x, name=None):
    return torch.neg(x)


def erf(x, name=None):
    return torch.erf(x)


def erfinv(x, name=None):
    return torch.erfinv(x)


def digamma(x, name=None):
    return torch.digamma(x)


def lgamma(x, name=None):
    return torch.lgamma(x)


def conj(x, name=None):
    return torch.conj_physical(x)


def angle(x, name=None):
    return torch.angle(x)


def real(x, name=None):
    return torch.real(x)


def imag(x, name=None):
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


def frac(x, name=None):
    return x - torch.trunc(x)


def rad2deg(x, name=None):
    return torch.rad2deg(x)


def deg2rad(x, name=None):
    return torch.deg2rad(x)


def isnan(x, name=None):
    return torch.isnan(x)


def isinf(x, name=None):
    return torch.isinf(x)


def isfinite(x, name=None):
    return torch.isfinite(x)


def clip(x, min=None, max=None, name=None):
    if min is None and max is None:
        return x
    return torch.clamp(x, min, max)


def lerp(x, y, weight, name=None):
    return x + weight * (y - x)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


# -- reductions ------------------------------------------------------------
def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    dt = dtype_mod.convert_dtype(dtype)
    if x.ndim == 0:
        return x.to(dt) if dt is not None else x.clone()
    return torch.sum(x, dim=dims(x, axis), keepdim=keepdim, dtype=dt)


def mean(x, axis=None, keepdim=False, name=None):
    x = float_of(x)
    if x.ndim == 0:
        return x.clone()
    return torch.mean(x, dim=dims(x, axis), keepdim=keepdim)


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    dt = dtype_mod.convert_dtype(dtype)
    if dt is not None:
        x = x.to(dt)
    return reduce(lambda t, d, k: torch.prod(t, d, keepdim=k), x, axis,
                  keepdim)


def max(x, axis=None, keepdim=False, name=None):
    if x.ndim == 0:
        return x.clone()
    return torch.amax(x, dim=dims(x, axis), keepdim=keepdim)


def min(x, axis=None, keepdim=False, name=None):
    if x.ndim == 0:
        return x.clone()
    return torch.amin(x, dim=dims(x, axis), keepdim=keepdim)


amax = max
amin = min


def logsumexp(x, axis=None, keepdim=False, name=None):
    return torch.logsumexp(float_of(x), dim=dims(x, axis), keepdim=keepdim)


def all(x, axis=None, keepdim=False, name=None):
    return reduce(lambda t, d, k: torch.all(t, d, keepdim=k), x.bool(),
                  axis, keepdim)


def any(x, axis=None, keepdim=False, name=None):
    return reduce(lambda t, d, k: torch.any(t, d, keepdim=k), x.bool(),
                  axis, keepdim)


def cumsum(x, axis=None, dtype=None, name=None):
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.cumsum(x, axis, dtype=dtype_mod.convert_dtype(dtype))


def cumprod(x, dim=None, dtype=None, name=None):
    if dim is None:
        x, dim = x.reshape(-1), 0
    return torch.cumprod(x, dim, dtype=dtype_mod.convert_dtype(dtype))


def count_nonzero(x, axis=None, keepdim=False, name=None):
    return torch.sum(x != 0, dim=dims(x, axis), keepdim=keepdim)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(x, offset, axis1, axis2).sum(-1)


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    return torch.diff(x, n, axis, prepend, append)


def kron(x, y, name=None):
    return torch.kron(x, y)


# -- matmul family ---------------------------------------------------------
def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    from ..amp import cast_if_amp
    x, y = cast_if_amp("matmul", x, y)
    if transpose_x and x.ndim > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.ndim > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def mm(x, y, name=None):
    return torch.matmul(x, y)


def bmm(x, y, name=None):
    return torch.matmul(x, y)


def dot(x, y, name=None):
    return torch.sum(x * y, dim=-1)


def mv(x, vec, name=None):
    return torch.matmul(x, vec)


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return beta * input + alpha * torch.matmul(x, y)


def multiplex(inputs, index, name=None):
    stacked = torch.stack(list(inputs), 0)   # (candidates, batch, ...)
    idx = index.reshape(-1).long()
    return stacked[idx, torch.arange(stacked.shape[1], device=idx.device)]


# -- misc ------------------------------------------------------------------
def increment(x, value=1.0, name=None):
    return x + value


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    out = x * scale + bias if bias_after_scale else (x + bias) * scale
    if act is not None:
        from ..nn import functional as F
        out = getattr(F, act)(out)
    return out


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return scale_b * torch.tanh(scale_a * x)


def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def gcd(x, y, name=None):
    return torch.gcd(x, y)


def lcm(x, y, name=None):
    return torch.lcm(x, y)


def add_n(inputs, name=None):
    """Sum a list of tensors (reference operators/sum_op.cc)."""
    if not isinstance(inputs, (list, tuple)):
        return inputs
    out = inputs[0]
    for t in inputs[1:]:
        out = torch.add(out, t)
    return out


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(x, offset, axis1, axis2)

