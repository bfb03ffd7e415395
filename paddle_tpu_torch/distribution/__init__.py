"""Probability distributions (port of ``paddle_tpu/distribution``;
reference python/paddle/distribution.py: Distribution, Uniform, Normal,
Categorical).

A distribution's parameters are float32 tensors on the device of the
tensors it is given (a Python number or an array is put on the CPU), and
everything it computes stays there. ``sample(shape, seed=0)`` draws from
``framework.random.get_generator(device)`` (the global seed's stream) or,
with a nonzero ``seed``, from a generator seeded with it, so a seeded
draw repeats. ``log_prob``, ``probs``, ``entropy`` and ``kl_divergence``
are the reference's formulas.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..framework.random import get_generator

__all__ = ["Distribution", "Uniform", "Normal", "Categorical"]


def _param(v, device=None) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to(torch.float32)
    return torch.as_tensor(np.asarray(v, np.float32),
                           device=device or "cpu")


def _value(v, like: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(like.device)
    return torch.as_tensor(np.asarray(v), device=like.device).to(dtype)


def _generator(device: torch.device, seed: int) -> torch.Generator:
    if seed:
        g = torch.Generator(device=device)
        g.manual_seed(int(seed))
        return g
    return get_generator(device)


class Distribution:
    def sample(self, shape=()):
        raise NotImplementedError

    def entropy(self):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def probs(self, value):
        return torch.exp(self.log_prob(value))

    def kl_divergence(self, other):
        raise NotImplementedError


def _pair(a, b):
    """Two parameters on one device (the first tensor's)."""
    dev = next((x.device for x in (a, b) if isinstance(x, torch.Tensor)),
               None)
    return _param(a, dev).to(dev or "cpu"), _param(b, dev).to(dev or "cpu")


class Uniform(Distribution):
    def __init__(self, low, high, name=None):
        self.low, self.high = _pair(low, high)

    def sample(self, shape=(), seed=0):
        shape = tuple(shape) + tuple(torch.broadcast_shapes(
            self.low.shape, self.high.shape))
        dev = self.low.device
        u = torch.rand(shape, generator=_generator(dev, seed), device=dev)
        return self.low + u * (self.high - self.low)

    def log_prob(self, value):
        value = _value(value, self.low)
        inside = (value >= self.low) & (value < self.high)
        lp = -torch.log(self.high - self.low)
        return torch.where(inside, lp, torch.full_like(lp, -math.inf))

    def entropy(self):
        return torch.log(self.high - self.low)


class Normal(Distribution):
    def __init__(self, loc, scale, name=None):
        self.loc, self.scale = _pair(loc, scale)

    def sample(self, shape=(), seed=0):
        shape = tuple(shape) + tuple(torch.broadcast_shapes(
            self.loc.shape, self.scale.shape))
        dev = self.loc.device
        return self.loc + self.scale * torch.randn(
            shape, generator=_generator(dev, seed), device=dev)

    def log_prob(self, value):
        value = _value(value, self.loc)
        var = torch.square(self.scale)
        return (-torch.square(value - self.loc) / (2 * var)
                - torch.log(self.scale) - 0.5 * math.log(2 * math.pi))

    def entropy(self):
        return 0.5 + 0.5 * math.log(2 * math.pi) + torch.log(self.scale)

    def kl_divergence(self, other: "Normal"):
        var_ratio = torch.square(self.scale / other.scale)
        t1 = torch.square((self.loc - other.loc) / other.scale)
        return 0.5 * (var_ratio + t1 - 1.0 - torch.log(var_ratio))


class Categorical(Distribution):
    def __init__(self, logits, name=None):
        self.logits = _param(logits)

    def sample(self, shape=(), seed=0):
        """Gumbel-max over the last axis, as ``jax.random.categorical``
        draws: indices (int64) of shape ``shape + logits.shape[:-1]``."""
        shape = tuple(shape) + tuple(self.logits.shape)
        dev = self.logits.device
        u = torch.rand(shape, generator=_generator(dev, seed), device=dev)
        tiny = torch.finfo(torch.float32).tiny
        gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
        return torch.argmax(self.logits + gumbel, dim=-1)

    def log_prob(self, value):
        logp = torch.log_softmax(self.logits, dim=-1)
        value = _value(value, logp, torch.int64).long()
        logp = logp.expand(*value.shape, logp.shape[-1]) \
            if value.dim() > logp.dim() - 1 else logp
        return torch.gather(logp, -1, value[..., None])[..., 0]

    def entropy(self):
        logp = torch.log_softmax(self.logits, dim=-1)
        p = torch.exp(logp)
        return -torch.sum(p * logp, dim=-1)

    def kl_divergence(self, other: "Categorical"):
        logp = torch.log_softmax(self.logits, dim=-1)
        logq = torch.log_softmax(other.logits, dim=-1)
        p = torch.exp(logp)
        return torch.sum(p * (logp - logq), dim=-1)
