"""``cross_entropy``, ``softmax_with_cross_entropy`` and
``fused_linear_cross_entropy`` (port of
``paddle_tpu/nn/functional/loss.py``'s).

``cross_entropy`` is plain PyTorch, as the reference's is one fused XLA
graph: the hard-label fast path takes float32 logsumexp minus the picked
logit without a log-prob tensor; soft labels, ``use_softmax=False``,
``weight``, ``ignore_index``, ``reduction`` and ``axis`` follow the
reference.

``fused_linear_cross_entropy`` is the LM-head projection plus softmax cross
entropy without materializing the (tokens, vocab) logits. ``kernel``:

- ``"pallas"``: the fused CE kernels (``ops/fused_ce.py``; on a CUDA tensor
  the three kernels of ``csrc/fused_ce.cu``, on a CPU tensor their plain
  versions);
- ``"chunked"``: ``ops/chunked_ce.py``, ``chunk`` classes per step;
- ``"auto"``: the kernels where their gate (``fused_ce_supported``: a CUDA
  tensor of a dtype and H the kernels take, the weight of the same dtype)
  allows, else the chunked path, counted by ``record_fallback("fused_ce")``,
  as the reference takes its kernel on the TPU and counts the chunked route
  elsewhere.
"""
from __future__ import annotations

import torch

from ...ops.chunked_ce import chunked_lm_ce
from ...ops.fused_ce import fused_ce_supported, fused_lm_ce
from ...ops.tuner import record_fallback

__all__ = ["cross_entropy", "softmax_with_cross_entropy",
           "fused_linear_cross_entropy"]


def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, name=None):
    """Softmax (or, with ``use_softmax=False``, log of the given
    probabilities) cross entropy along ``axis``. Hard labels may carry the
    class axis as a size-1 dim; ``weight`` is a per-class weight."""
    axis = axis % input.dim()
    if use_softmax:
        logp = torch.log_softmax(input, dim=axis) if soft_label else None
    else:
        logp = torch.log(input.clamp(min=1e-30))
    if soft_label:
        loss = -(label * logp).sum(dim=axis)
        return _reduce(loss, reduction)
    lbl = label.long()
    if lbl.dim() == input.dim():
        lbl = lbl.squeeze(axis)
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, torch.zeros_like(lbl))
    idx = safe.unsqueeze(axis)
    if logp is None:
        # the hard-label fast path: lse(logits) - logit[label], lse in
        # float32 whatever the input dtype
        lse = torch.logsumexp(input.float(), dim=axis)
        picked = input.gather(axis, idx).squeeze(axis).float()
        loss = lse - picked
    else:
        loss = -logp.gather(axis, idx).squeeze(axis)
    if weight is not None:
        w = weight[safe]
        loss = loss * w
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if reduction == "mean":
        denom = torch.where(valid, weight[safe] if weight is not None
                            else torch.ones_like(loss),
                            torch.zeros_like(loss)).sum()
        return loss.sum() / denom.clamp(min=1e-12)
    return _reduce(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """Per-sample loss with the class axis kept as size 1."""
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis)
    loss = loss.unsqueeze(axis % logits.dim())
    if return_softmax:
        return loss, torch.softmax(logits, dim=axis)
    return loss


def fused_linear_cross_entropy(hidden, weight, labels, ignore_index=-100,
                               chunk=8192, kernel="auto", interpret=None,
                               name=None):
    """Mean float32 loss over labels != ``ignore_index``, gradients to
    hidden and weight. hidden: (..., H); weight: (H, V); labels: (...)."""
    if kernel == "auto":
        if fused_ce_supported(hidden, weight):
            kernel = "pallas"
        else:
            record_fallback("fused_ce")
            kernel = "chunked"
    if kernel == "pallas":
        return fused_lm_ce(hidden, weight, labels, ignore_index=ignore_index,
                           interpret=interpret)
    if kernel == "chunked":
        return chunked_lm_ce(hidden, weight, labels, chunk=chunk,
                             ignore_index=ignore_index)
    raise ValueError(
        f"kernel must be 'auto', 'pallas' or 'chunked', got {kernel!r}")
