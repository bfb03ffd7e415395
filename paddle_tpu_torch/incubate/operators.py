"""Incubate fused operators (port of ``paddle_tpu/incubate/operators.py``;
reference python/paddle/incubate/operators/
softmax_mask_fuse_upper_triangle.py, a CUDA-fused causal-masked softmax
of transformer attention scores).

The reference writes it as plain ``jnp`` (mask + softmax in one jit
scope), not as a Pallas kernel; the port's counterpart is plain PyTorch.
The attention path proper runs the flash kernels (``ops.flash_attention``).
"""
from __future__ import annotations

import torch

__all__ = ["softmax_mask_fuse_upper_triangle"]


def softmax_mask_fuse_upper_triangle(x):
    """Softmax over the last axis with the strict upper triangle masked
    out (causal attention scores), in x's dtype. x: (batch, heads, S_q,
    S_k), a tensor (on any device) or an array (on the CPU)."""
    x = torch.as_tensor(x)
    s_q, s_k = x.shape[-2], x.shape[-1]
    causal = torch.ones((s_q, s_k), dtype=torch.bool,
                        device=x.device).tril()
    dtype = x.dtype if x.is_floating_point() else torch.float32
    x = x.to(dtype)
    neg = torch.tensor(torch.finfo(dtype).min, dtype=dtype, device=x.device)
    masked = torch.where(causal, x, neg)
    out = torch.exp(masked - masked.amax(dim=-1, keepdim=True))
    out = out / out.sum(dim=-1, keepdim=True)
    # exact zeros on masked positions (softmax of -inf-like values can
    # leave denormals in low precision)
    return torch.where(causal, out, torch.zeros((), dtype=out.dtype,
                                                device=out.device))
