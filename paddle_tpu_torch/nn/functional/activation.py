"""``gelu`` (port of ``paddle_tpu/nn/functional/activation.py``'s)."""
from __future__ import annotations

import torch

__all__ = ["gelu"]


def gelu(x, approximate=False, name=None):
    """approximate=True is the tanh form, as ``jax.nn.gelu`` has it."""
    return torch.nn.functional.gelu(x, approximate="tanh" if approximate
                                    else "none")
