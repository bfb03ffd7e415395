"""Chunked LM-head cross entropy: softmax CE of ``hidden @ weight`` against
integer labels without ever holding the (tokens, vocab) logits.

Port of ``paddle_tpu/ops/chunked_ce.py`` as a ``torch.autograd.Function``.
The forward runs an online logsumexp over vocab chunks of ``chunk``
classes; the backward recomputes each chunk's logits from the saved
hidden states and lse and accumulates dW into one float32 buffer. Logits
are float32 whatever the input dtype; peak extra memory is
O(tokens * chunk). The last chunk is simply narrower where the reference
pads the weight with zero columns and masks them to -inf: both give the
same sums. The matmuls are plain ``torch.matmul`` (the reference leaves
them to XLA); the fused kernels of ``ops/fused_ce.py`` are the other
route, and this function is their parity oracle in the tests.
"""
from __future__ import annotations

import torch

__all__ = ["chunked_lm_ce"]


def _chunks(v: int, chunk: int):
    return [(c0, min(c0 + chunk, v)) for c0 in range(0, v, chunk)]


class _ChunkedCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, hidden, weight, labels, chunk, ignore_index):
        h_dim, v = weight.shape
        hid32 = hidden.reshape(-1, h_dim).float()
        lbl = labels.reshape(-1).to(hid32.device).long()
        valid = lbl != ignore_index
        safe = torch.where(valid, lbl, torch.zeros_like(lbl))
        n = hid32.shape[0]
        m = torch.full((n,), float("-inf"), device=hid32.device)
        s = torch.zeros(n, device=hid32.device)
        tgt = torch.zeros(n, device=hid32.device)
        for c0, c1 in _chunks(v, chunk):
            logits = hid32 @ weight[:, c0:c1].float()              # (N, C)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            s = s * torch.exp(m - m_new) + \
                torch.exp(logits - m_new[:, None]).sum(dim=-1)
            m = m_new
            in_chunk = (safe >= c0) & (safe < c1)
            local = (safe - c0).clamp(0, c1 - c0 - 1)
            picked = logits.gather(1, local[:, None])[:, 0]
            tgt = torch.where(in_chunk, picked, tgt)
        lse = m + torch.log(s)
        per_tok = torch.where(valid, lse - tgt, torch.zeros_like(lse))
        denom = valid.sum().float().clamp(min=1.0)
        ctx.save_for_backward(hidden, weight, safe, valid, lse, denom)
        ctx.chunk = chunk
        return per_tok.sum() / denom

    @staticmethod
    def backward(ctx, g):
        hidden, weight, safe, valid, lse, denom = ctx.saved_tensors
        h_dim, v = weight.shape
        hid32 = hidden.reshape(-1, h_dim).float()
        scale = (g / denom) * valid.float()                        # (N,)
        dh = torch.zeros_like(hid32)
        dw = torch.empty((h_dim, v), dtype=torch.float32, device=hid32.device)
        for c0, c1 in _chunks(v, ctx.chunk):
            w32 = weight[:, c0:c1].float()
            p = torch.exp(hid32 @ w32 - lse[:, None])              # softmax
            in_chunk = (safe >= c0) & (safe < c1)
            local = (safe - c0).clamp(0, c1 - c0 - 1)
            onehot = torch.zeros_like(p).scatter_(
                1, local[:, None], in_chunk[:, None].float())
            d_logits = (p - onehot) * scale[:, None]
            dh += d_logits @ w32.T
            dw[:, c0:c1] = hid32.T @ d_logits
        return (dh.reshape(hidden.shape).to(hidden.dtype),
                dw.to(weight.dtype), None, None, None)


def chunked_lm_ce(hidden, weight, labels, chunk: int = 8192,
                  ignore_index: int = -100) -> torch.Tensor:
    """Mean CE of softmax(hidden @ weight) vs integer labels over the
    tokens whose label is not ``ignore_index``.

    hidden: (..., H); weight: (H, V); labels: (...) int. Returns a float32
    scalar, differentiable wrt hidden and weight."""
    return _ChunkedCE.apply(hidden, weight, labels, int(chunk),
                            int(ignore_index))
