"""Chunked LM-head cross entropy: softmax CE of ``hidden @ weight`` against
integer labels without ever holding the (tokens, vocab) logits.

Port of ``paddle_tpu/ops/chunked_ce.py``. The forward runs as plain ops on
detached inputs, so a ``make_fx`` trace shows its matmuls as the
reference's scan shows its dots; the loss then passes through the library
op ``paddle_tpu_torch::chunked_ce_grad`` (the loss unchanged, its backward
registered with ``register_autograd``), so a staged graph keeps the
chunked backward as the eager call has it.
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


def _bookkeeping(labels, ignore_index, device):
    lbl = labels.reshape(-1).to(device).long()
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, torch.zeros_like(lbl))
    return safe, valid, valid.sum().float().clamp(min=1.0)


def _chunked_fwd(hidden, weight, labels, chunk, ignore_index):
    """-> (loss, lse): the mean loss and each token's float32 lse."""
    h_dim, v = weight.shape
    hid32 = hidden.reshape(-1, h_dim).float()
    safe, valid, denom = _bookkeeping(labels, ignore_index, hid32.device)
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
    return per_tok.sum() / denom, lse


def _chunked_setup_context(ctx, inputs, output):
    hidden, weight, labels, lse, loss, chunk, ignore_index = inputs
    ctx.save_for_backward(hidden, weight, labels, lse)
    ctx.chunk, ctx.ignore_index = chunk, ignore_index


def _chunked_backward(ctx, g):
    """Recomputes each chunk's logits from the saved hidden states and
    lse; dW accumulates into one float32 buffer."""
    hidden, weight, labels, lse = ctx.saved_tensors
    h_dim, v = weight.shape
    hid32 = hidden.reshape(-1, h_dim).float()
    safe, valid, denom = _bookkeeping(labels, ctx.ignore_index,
                                      hid32.device)
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
            dw.to(weight.dtype), None, None, None, None, None)


def _grad_carrier(hidden, weight, labels, lse, loss, chunk, ignore_index):
    return loss.clone()


# the loss's carrier: its value passes through, its backward is the
# chunked one
_LIB = torch.library.Library("paddle_tpu_torch", "FRAGMENT")
_LIB.define("chunked_ce_grad(Tensor hidden, Tensor weight, Tensor labels, "
            "Tensor lse, Tensor loss, int chunk, int ignore_index) -> Tensor")
_LIB.impl("chunked_ce_grad", _grad_carrier, "CompositeExplicitAutograd")


@torch.library.register_fake("paddle_tpu_torch::chunked_ce_grad", lib=_LIB)
def _(hidden, weight, labels, lse, loss, chunk, ignore_index):
    return loss.new_empty(loss.shape)


torch.library.register_autograd("paddle_tpu_torch::chunked_ce_grad",
                                _chunked_backward,
                                setup_context=_chunked_setup_context,
                                lib=_LIB)

#: ``torch.ops.paddle_tpu_torch.chunked_ce_grad``
CHUNKED_CE_GRAD_OP = torch.ops.paddle_tpu_torch.chunked_ce_grad


def chunked_lm_ce(hidden, weight, labels, chunk: int = 8192,
                  ignore_index: int = -100) -> torch.Tensor:
    """Mean CE of softmax(hidden @ weight) vs integer labels over the
    tokens whose label is not ``ignore_index``.

    hidden: (..., H); weight: (H, V); labels: (...) int. Returns a float32
    scalar, differentiable wrt hidden and weight."""
    chunk, ignore_index = int(chunk), int(ignore_index)
    loss, lse = _chunked_fwd(hidden.detach(), weight.detach(), labels,
                             chunk, ignore_index)
    return CHUNKED_CE_GRAD_OP(hidden, weight, labels, lse, loss, chunk,
                              ignore_index)
