"""The loss functionals (port of ``paddle_tpu/nn/functional/loss.py``):
``cross_entropy``, ``softmax_with_cross_entropy``,
``fused_linear_cross_entropy``, and ``nll_loss``, ``mse_loss``,
``l1_loss``, ``smooth_l1_loss``, the binary cross entropies, ``kl_div``,
the margin, hinge, cosine and triplet losses, ``log_loss``,
``square_error_cost``, ``sigmoid_focal_loss``, ``ctc_loss``,
``npair_loss``, ``dice_loss`` and ``hsigmoid_loss``, each with the
reference's formula, clamps and reductions.

``ctc_loss`` is the reference's log-space forward algorithm written out:
a loop over time on (B, 2L+1) alphas with the reference's -1e30 floor,
its ``mean`` over label lengths and its ``norm_by_times``, not
``torch.nn.functional.ctc_loss``, whose reductions and blank handling
differ. ``hsigmoid_loss`` walks the heap-numbered default tree (or a
custom ``path_table``/``path_code``), padded to the tree's depth and
masked.

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

import math

import torch

from ...ops.chunked_ce import chunked_lm_ce
from ...ops.fused_ce import fused_ce_supported, fused_lm_ce
from ...ops.tuner import record_fallback

__all__ = ["cross_entropy", "softmax_with_cross_entropy",
           "fused_linear_cross_entropy", "nll_loss", "mse_loss", "l1_loss",
           "smooth_l1_loss", "binary_cross_entropy",
           "binary_cross_entropy_with_logits", "kl_div",
           "margin_ranking_loss", "hinge_embedding_loss",
           "cosine_embedding_loss", "triplet_margin_loss", "log_loss",
           "square_error_cost", "sigmoid_focal_loss", "ctc_loss",
           "npair_loss", "mae_loss", "dice_loss", "hsigmoid_loss"]


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


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """``-input[n, label[n]]`` (log-probabilities in, class axis 1)."""
    lbl = label.long()
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, torch.zeros_like(lbl))
    picked = -input.gather(1, safe.unsqueeze(1)).squeeze(1)
    if weight is not None:
        picked = picked * weight[safe]
    picked = torch.where(valid, picked, torch.zeros_like(picked))
    if reduction == "mean":
        w = weight[safe] if weight is not None else torch.ones_like(picked)
        denom = torch.where(valid, w, torch.zeros_like(w)).sum()
        return picked.sum() / denom.clamp(min=1e-12)
    return _reduce(picked, reduction)


def mse_loss(input, label, reduction="mean", name=None):
    return _reduce(torch.square(input - label), reduction)


def l1_loss(input, label, reduction="mean", name=None):
    return _reduce(torch.abs(input - label), reduction)


def mae_loss(input, label, reduction="mean"):
    return l1_loss(input, label, reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    """Huber's loss times ``delta``, as Paddle scales it."""
    diff = torch.abs(input - label)
    loss = torch.where(diff < delta, 0.5 * diff * diff / delta,
                       diff - 0.5 * delta)
    return _reduce(loss * delta, reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    eps = 1e-12
    loss = -(label * torch.log(input.clamp(min=eps)) +
             (1.0 - label) * torch.log((1.0 - input).clamp(min=eps)))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    max_val = (-logit).clamp(min=0)
    soft = torch.log1p(torch.exp(-torch.abs(logit)))
    if pos_weight is not None:
        log_w = (pos_weight - 1.0) * label + 1.0
        loss = (1.0 - label) * logit + log_w * (soft + max_val)
    else:
        loss = (1.0 - label) * logit + soft + max_val
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def kl_div(input, label, reduction="mean", name=None):
    """``label * (log(label) - input)``, ``batchmean`` over dim 0."""
    loss = label * (torch.log(label.clamp(min=1e-12)) - input)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return _reduce((-label * (input - other) + margin).clamp(min=0.0),
                   reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    loss = torch.where(label == 1.0, input, (margin - input).clamp(min=0.0))
    return _reduce(loss, reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    from .common import cosine_similarity
    cos = cosine_similarity(input1, input2, axis=1)
    loss = torch.where(label == 1, 1.0 - cos, (cos - margin).clamp(min=0.0))
    return _reduce(loss, reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    def dist(a, b):
        return (torch.abs(a - b + epsilon) ** p).sum(dim=-1) ** (1.0 / p)
    dp = dist(input, positive)
    dn = dist(input, negative)
    if swap:
        dn = torch.minimum(dn, dist(positive, negative))
    return _reduce((dp - dn + margin).clamp(min=0.0), reduction)


def log_loss(input, label, epsilon=1e-4, name=None):
    return -(label * torch.log(input + epsilon) +
             (1.0 - label) * torch.log(1.0 - input + epsilon))


def square_error_cost(input, label):
    return torch.square(input - label)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    p = torch.sigmoid(logit)
    ce = binary_cross_entropy_with_logits(logit, label, reduction="none")
    p_t = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    loss = a_t * ((1 - p_t) ** gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC's negative log likelihood by the forward algorithm in log
    space. log_probs (T, B, C) log-softmax outputs; labels (B, L)
    padded; ``mean`` averages each loss over its label length."""
    t_len, b, _ = log_probs.shape
    n_lab = labels.shape[1]
    s_len = 2 * n_lab + 1
    neg = -1e30
    dev = log_probs.device
    labels = labels.long()
    ext = torch.full((b, s_len), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels
    skip = torch.zeros((b, s_len), dtype=torch.bool, device=dev)
    skip[:, 2:] = (ext[:, 2:] != ext[:, :-2]) & (ext[:, 2:] != blank)
    rows = torch.arange(b, device=dev)
    floor = torch.full((b, s_len), neg, dtype=log_probs.dtype, device=dev)
    alpha = floor.clone()
    alpha[:, 0] = log_probs[0, rows, ext[:, 0]]
    if n_lab > 0:
        alpha[:, 1] = log_probs[0, rows, ext[:, 1]]
    alphas = [alpha]
    for t in range(1, t_len):
        emit = log_probs[t].gather(1, ext)
        prev1 = torch.cat([floor[:, :1], alpha[:, :-1]], dim=1)
        prev2 = torch.cat([floor[:, :2], alpha[:, :-2]], dim=1)
        prev2 = torch.where(skip, prev2, floor)
        alpha = torch.logaddexp(torch.logaddexp(alpha, prev1), prev2) + emit
        alphas.append(alpha)
    alphas = torch.stack(alphas)                               # (T, B, S)
    input_lengths = torch.as_tensor(input_lengths, device=dev)
    label_lengths = torch.as_tensor(label_lengths, device=dev)
    last = alphas[(input_lengths.long() - 1).clamp(0, t_len - 1), rows]
    s_last = (2 * label_lengths.long()).clamp(max=s_len - 1)
    s_prev = (2 * label_lengths.long() - 1).clamp(0, s_len - 1)
    loss = -torch.logaddexp(last.gather(1, s_last[:, None])[:, 0],
                            last.gather(1, s_prev[:, None])[:, 0])
    if norm_by_times:
        loss = loss / input_lengths.to(loss.dtype).clamp(min=1.0)
    if reduction == "mean":
        return (loss / label_lengths.to(loss.dtype).clamp(min=1.0)).mean()
    return _reduce(loss, reduction)


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    reg = l2_reg * ((anchor * anchor).sum(dim=1).mean() +
                    (positive * positive).sum(dim=1).mean()) * 0.25
    sim = anchor @ positive.T
    labels = labels.reshape(-1)
    same = (labels[:, None] == labels[None, :]).to(sim.dtype)
    tgt = same / same.sum(dim=1, keepdim=True)
    xe = -(tgt * torch.log_softmax(sim, dim=1)).sum(dim=1)
    return xe.mean() + reg


def dice_loss(input, label, epsilon=1e-5, name=None):
    """input (N, ..., C) class probabilities, label (N, ..., 1) ids."""
    from .common import one_hot
    onehot = one_hot(label.squeeze(-1), input.shape[-1]).to(input.dtype)
    dims = tuple(range(1, input.dim()))
    inter = (input * onehot).sum(dim=dims)
    denom = input.sum(dim=dims) + onehot.sum(dim=dims)
    return (1 - (2 * inter + epsilon) / (denom + epsilon)).mean()


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid loss, (N, 1). The default tree numbers its
    nodes as a heap over ``num_classes`` leaves: the internal nodes 1 ..
    num_classes - 1 are the rows of ``weight`` (num_classes - 1, D); a
    custom tree comes as ``path_table``/``path_code`` (-1 pads a path).
    Logits are clipped to [-40, 40]; a node's loss is
    ``-log sigmoid((2 * bit - 1) * z)``."""
    x = input
    label = torch.as_tensor(label, device=x.device).reshape(-1).long()
    if path_table is not None:
        table = torch.as_tensor(path_table, device=x.device).long()
        node_ids = table[label]                            # (N, depth)
        codes = torch.as_tensor(path_code, device=x.device)[label].to(
            x.dtype)
        mask = (node_ids >= 0).to(x.dtype)
        rows = node_ids.clamp(min=0)
    else:
        depth = max(1, int(math.ceil(math.log2(max(2, num_classes)))))
        node = label + num_classes                         # heap leaf id
        nodes, bits = [], []
        for _ in range(depth):
            bits.append((node % 2).to(x.dtype))
            node = node // 2
            nodes.append(node)
        node_ids = torch.stack(nodes, dim=1)
        codes = torch.stack(bits, dim=1)
        mask = (node_ids >= 1).to(x.dtype)
        rows = (node_ids - 1).clamp(min=0)
    w = weight[rows]                                       # (N, depth, D)
    logits = torch.einsum("nd,nkd->nk", x, w)
    if bias is not None:
        logits = logits + bias.reshape(-1)[rows]
    logits = logits.clamp(-40.0, 40.0)
    sign = 2.0 * codes - 1.0
    loss = -torch.nn.functional.logsigmoid(sign * logits) * mask
    return loss.sum(dim=1, keepdim=True)
