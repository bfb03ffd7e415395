"""Fused all-finite reduction for the trainer's in-step NaN guard.

Port of ``paddle_tpu/resilience/guard.py``: ``all_finite`` takes one
``isfinite().all()`` partial per floating tensor, stacked and reduced once
on the device. The result is a 0-d bool tensor on that device; nothing
here waits for it, so the guard costs no host sync. ``all_finite_value``
is the host form over a nested dict (one sync for the bool).
"""
from __future__ import annotations

from typing import Iterable

import torch

__all__ = ["all_finite", "all_finite_value"]


def all_finite(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """0-d bool: every floating tensor is finite. Non-floating tensors are
    ignored; an empty collection is vacuously finite (on the CPU)."""
    parts = [torch.isfinite(t).all() for t in tensors
             if t is not None and t.is_floating_point()]
    if not parts:
        return torch.tensor(True)
    if len(parts) == 1:
        return parts[0]
    return torch.stack(parts).all()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def all_finite_value(tree) -> bool:
    """Host form: every floating tensor of a nested dict/list is finite
    (one device sync)."""
    return bool(all_finite(list(_leaves(tree))))
