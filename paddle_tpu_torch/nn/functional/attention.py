"""``scaled_dot_product_attention``: the flash kernels where their gate
allows, else the plain attention.

Port of ``paddle_tpu/nn/functional/attention.py``. The gate is the JAX
package's, with the card in place of the TPU, and the kernels' own limits:
a CUDA tensor of float32 or bfloat16, at least 512 query positions,
head_dim in {64, 128, 256}, batch*heads at most 65535 and no dense
``attn_mask`` (``kv_lens`` padding masks and dropout run inside the
kernels). A shape the
gate rejects goes to :func:`_xla_attention`, the reference's plain
attention in PyTorch, and is counted by ``record_fallback``. On a CUDA
tensor that passes the gate a kernel that fails raises; nothing catches
it.
"""
from __future__ import annotations

import torch

from ...framework.random import draw_seed
from ...ops.flash_attention import flash_attention, flash_supported
from ...ops.tuner import record_fallback
from .common import dropout as _dropout

__all__ = ["scaled_dot_product_attention"]


def _xla_attention(q, k, v, mask=None, scale=None, causal=False,
                   dropout_p=0.0, training=True):
    """The reference's plain attention with its dtypes: logits from an
    einsum in the inputs' dtype, masked with that dtype's ``finfo.min``,
    softmax in float32 and cast back. q/k/v (B, S, H, D)."""
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    logits = torch.einsum("bshd,bthd->bhst", q, k) * scale
    low = torch.finfo(logits.dtype).min
    if causal:
        s, t = logits.shape[-2:]
        cm = torch.ones(s, t, dtype=torch.bool, device=q.device).tril()
        logits = torch.where(cm, logits, torch.full_like(logits, low))
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = torch.where(mask, logits, torch.full_like(logits, low))
        else:
            logits = logits + mask
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    if dropout_p > 0.0 and training:
        probs = _dropout(probs, p=dropout_p, training=True)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, kv_lens=None, name=None):
    """query/key/value: (batch, seq, num_heads, head_dim).

    kv_lens: optional (batch,) valid key/value counts, the O(B) form of a
    trailing-padding key mask; it keeps padded batches on the kernels.
    """
    if attn_mask is None and flash_supported(query, key, min_seq=512):
        rate, seed = 0.0, None
        if dropout_p > 0.0 and training:
            rate = float(dropout_p)
            seed = draw_seed(query.device)
        return flash_attention(query, key, value, causal=is_causal,
                               kv_lens=kv_lens, dropout_rate=rate,
                               dropout_seed=seed)
    record_fallback("flash_attention")
    if kv_lens is not None:
        t = key.shape[1]
        lens_mask = (torch.arange(t, device=key.device)[None, None, None, :]
                     < torch.as_tensor(kv_lens, device=key.device)
                     .reshape(-1, 1, 1, 1))
        if attn_mask is None:
            attn_mask = lens_mask
        elif attn_mask.dtype == torch.bool:
            attn_mask = attn_mask & lens_mask
        else:   # additive bias: padding keys get -inf-like logits
            attn_mask = attn_mask + torch.where(
                lens_mask, 0.0, torch.finfo(torch.float32).min)
    return _xla_attention(query, key, value, mask=attn_mask,
                          causal=is_causal, dropout_p=dropout_p,
                          training=training)
