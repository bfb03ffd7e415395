"""Gradient clipping (port of ``paddle_tpu/optimizer/clip.py``): pure
functions over ``{name: grad}`` dicts, float32 norms, results in each
grad's dtype."""
from __future__ import annotations

import torch

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grads"]


class ClipGradBase:
    def __call__(self, grads: dict) -> dict:
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def __call__(self, grads):
        return {k: g.clamp(self.min, self.max) if g is not None else None
                for k, g in grads.items()}


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, grads):
        out = {}
        for k, g in grads.items():
            if g is None:
                out[k] = None
                continue
            norm = g.float().square().sum().sqrt()
            scale = torch.clamp(self.clip_norm / norm.clamp(min=1e-12),
                                max=1.0)
            out[k] = (g * scale).to(g.dtype)
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def global_norm_sq(self, grads):
        sq = [g.float().square().sum() for g in grads.values()
              if g is not None]
        return torch.stack(sq).sum() if sq else torch.zeros(())

    def __call__(self, grads):
        gnorm = self.global_norm_sq(grads).sqrt()
        scale = self.clip_norm / gnorm.clamp(min=self.clip_norm)
        return {k: (g * scale).to(g.dtype) if g is not None else None
                for k, g in grads.items()}


def clip_grads(grads, clip):
    if clip is None:
        return grads
    return clip(grads)
