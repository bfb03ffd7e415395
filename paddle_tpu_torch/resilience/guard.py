"""Fused all-finite reduction for the trainer's in-step NaN guard.

Port of ``paddle_tpu/resilience/guard.py``'s ``all_finite``: one
``isfinite().all()`` partial per floating tensor, stacked and reduced once
on the device. The result is a 0-d bool tensor on that device; nothing
here waits for it, so the guard costs no host sync.
"""
from __future__ import annotations

from typing import Iterable

import torch

__all__ = ["all_finite"]


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
