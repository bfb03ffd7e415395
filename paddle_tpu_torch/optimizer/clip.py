"""Gradient clipping (port of ``paddle_tpu/optimizer/clip.py``): pure
functions over ``{name: grad}`` dicts, float32 norms, results in each
grad's dtype.

``split`` says which gradients are this rank's slices of parameters
split over other ranks (a ZeRO trainer's ``sharding`` slices, a
tensor-parallel ``model`` slice, a pipeline stage's members): a norm sums
their squares over the process group of those ranks, the norm the
reference takes of its global arrays. It is ``{key: group}``, or None
when no key is split."""
from __future__ import annotations

import torch

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grads"]


class ClipGradBase:
    def __call__(self, grads: dict, split=None) -> dict:
        raise NotImplementedError


def _sum_over(sq: torch.Tensor, group) -> torch.Tensor:
    """``sq`` summed over the ranks of ``group``."""
    import torch.distributed as dist
    out = sq.reshape(1).clone()
    dist.all_reduce(out, group=group)
    return out[0]


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def __call__(self, grads, split=None):
        return {k: g.clamp(self.min, self.max) if g is not None else None
                for k, g in grads.items()}


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, grads, split=None):
        groups = split or {}
        out = {}
        for k, g in grads.items():
            if g is None:
                out[k] = None
                continue
            sq = g.float().square().sum()
            norm = (_sum_over(sq, groups[k]) if k in groups else sq).sqrt()
            scale = torch.clamp(self.clip_norm / norm.clamp(min=1e-12),
                                max=1.0)
            out[k] = (g * scale).to(g.dtype)
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def global_norm_sq(self, grads, split=None):
        """The squared global norm; the slices of ``split`` summed over
        their group (one sum a group, in the order the groups first
        appear), then added to the whole leaves'."""
        groups = split or {}
        sq = [g.float().square().sum() for k, g in grads.items()
              if g is not None and k not in groups]
        total = torch.stack(sq).sum() if sq else torch.zeros(())
        order = list(dict.fromkeys(groups.values()))
        for group in order:
            parts = [g.float().square().sum() for k, g in grads.items()
                     if g is not None and groups.get(k) is group]
            part = torch.stack(parts).sum() if parts else \
                torch.zeros((), device=total.device)
            total = total.to(part.device) + _sum_over(part, group)
        return total

    def __call__(self, grads, split=None):
        gnorm = self.global_norm_sq(grads, split).sqrt()
        scale = self.clip_norm / gnorm.clamp(min=self.clip_norm)
        return {k: (g * scale).to(g.dtype) if g is not None else None
                for k, g in grads.items()}


def clip_grads(grads, clip, split=None):
    if clip is None:
        return grads
    return clip(grads) if split is None else clip(grads, split=split)
