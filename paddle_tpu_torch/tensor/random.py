"""Random sampling ops (reference: python/paddle/tensor/random.py).

Port of ``paddle_tpu/tensor/random.py``. Every draw comes from the port's
generators (``framework.random.get_generator``), seeded by
``paddle_tpu_torch.seed``, never from torch's global one. Like torch's
factories they draw on the CPU unless ``device=`` names another device;
the ``*_like`` draws and ``bernoulli``/``poisson``/``multinomial`` take
the device of their tensor. The two frameworks give different numbers
from one seed: only shapes, dtypes and moments compare.
"""
from __future__ import annotations

import torch

from ..framework import dtype as dtype_mod
from ..framework.random import get_generator

__all__ = ["rand", "randn", "standard_normal", "normal", "uniform",
           "randint", "randint_like", "randperm", "bernoulli", "poisson",
           "multinomial", "exponential_", "check_shape", "get_rng_key"]


def _float_dt(dtype):
    return dtype_mod.convert_dtype(dtype) or dtype_mod.get_default_dtype()


def _shape(shape):
    if isinstance(shape, torch.Tensor):
        return tuple(int(s) for s in shape.reshape(-1).tolist())
    return tuple(int(s) for s in shape)


def get_rng_key(device="cpu") -> torch.Generator:
    """The generator draws take on ``device`` (the reference's key)."""
    return get_generator(device)


def rand(shape, dtype=None, name=None, device="cpu"):
    return torch.rand(_shape(shape), generator=get_generator(device),
                      device=device, dtype=_float_dt(dtype))


def randn(shape, dtype=None, name=None, device="cpu"):
    return torch.randn(_shape(shape), generator=get_generator(device),
                       device=device, dtype=_float_dt(dtype))


def standard_normal(shape, dtype=None, name=None, device="cpu"):
    return randn(shape, dtype, device=device)


def normal(mean=0.0, std=1.0, shape=None, name=None, device=None):
    if device is None:
        device = next((t.device for t in (mean, std)
                       if isinstance(t, torch.Tensor)), torch.device("cpu"))
    if shape is None:
        shape = torch.broadcast_shapes(
            *[tuple(t.shape) for t in (mean, std)
              if isinstance(t, torch.Tensor)]) if any(
            isinstance(t, torch.Tensor) for t in (mean, std)) else ()
    z = torch.randn(_shape(shape), generator=get_generator(device),
                    device=device)
    return mean + std * z


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None,
            device="cpu"):
    gen = get_generator(device)
    if seed:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
    u = torch.rand(_shape(shape), generator=gen, device=device,
                   dtype=_float_dt(dtype))
    return u * (max - min) + min


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None,
            device="cpu"):
    if high is None:
        low, high = 0, low
    return torch.randint(int(low), int(high), _shape(shape),
                         generator=get_generator(device), device=device,
                         dtype=dtype_mod.convert_dtype(dtype))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    dt = dtype_mod.convert_dtype(dtype) or x.dtype
    return randint(low, high, x.shape, dt, device=x.device)


def randperm(n, dtype="int64", name=None, device="cpu"):
    return torch.randperm(int(n), generator=get_generator(device),
                          device=device,
                          dtype=dtype_mod.convert_dtype(dtype))


def bernoulli(x, name=None):
    return torch.bernoulli(x, generator=get_generator(x.device))


def poisson(x, name=None):
    return torch.poisson(x, generator=get_generator(x.device))


def multinomial(x, num_samples=1, replacement=False, name=None):
    return torch.multinomial(x, num_samples, replacement=replacement,
                             generator=get_generator(x.device))


def exponential_(x, lam=1.0, name=None):
    return x.exponential_(lam, generator=get_generator(x.device))


def check_shape(shape):
    """Validate a shape argument for random ops (reference
    tensor/random.py check_shape): entries must be positive ints (or a
    0-D/1-D integer tensor)."""
    shape = list(_shape(shape if isinstance(shape, torch.Tensor)
                        else list(shape)))
    for s in shape:
        if int(s) <= 0:
            raise ValueError(f"shape entries must be positive, got {shape}")
    return shape
