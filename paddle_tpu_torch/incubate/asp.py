"""ASP — automatic structured (n:m) sparsity (port of
``paddle_tpu/incubate/asp.py``; reference
python/paddle/fluid/contrib/sparsity/asp.py prune_model/decorate and
utils.py's mask algorithms).

The semantics of the reference: n:m-sparse weights kept through training
by masking the dense weights after every optimizer step. Hopper's 2:4
sparse tensor cores are not used: the reference only masks, and a sparse
GEMM would be a feature the JAX package lacks. The masks are computed on
the weight's device; within a group the largest magnitudes win and ties
go to the earlier position (a stable sort, as ``jnp.argsort``'s).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["compute_nm_mask", "check_sparsity", "prune_model",
           "prune_params", "decorate", "reset"]

_MASKS: Dict[int, Dict[str, torch.Tensor]] = {}  # id(model) -> name -> mask


def _as_tensor(w) -> torch.Tensor:
    return w.detach() if isinstance(w, torch.Tensor) else \
        torch.as_tensor(np.asarray(w))


def compute_nm_mask(w, n: int = 2, m: int = 4) -> torch.Tensor:
    """Per group of ``m`` consecutive elements along the LAST dim, keep the
    ``n`` largest magnitudes (reference sparsity/utils.py get_mask_1d);
    a float32 mask of w's shape on w's device."""
    w = _as_tensor(w)
    if w.shape[-1] % m != 0:
        return torch.ones(w.shape, dtype=torch.float32, device=w.device)
    groups = w.reshape(-1, m)
    if groups.dtype in (torch.bfloat16, torch.float16):
        groups = groups.float()          # exact: the same order and ties
    order = torch.argsort(-groups.abs(), dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)  # rank of each
    return (ranks < n).to(torch.float32).reshape(w.shape)


def check_sparsity(w, n: int = 2, m: int = 4) -> bool:
    """True iff every m-group along the last dim has <= n nonzeros
    (reference sparsity/utils.py check_mask_1d)."""
    w = _as_tensor(w)
    if w.shape[-1] % m != 0:
        return False
    nz = (w.reshape(-1, m) != 0).sum(dim=-1)
    return bool((nz <= n).all())


def _prunable(name: str, p, m: int = 4) -> bool:
    return (getattr(p, "requires_grad", True) and p.dim() == 2
            and p.shape[-1] % m == 0 and name.endswith("weight"))


def prune_model(model, n: int = 2, m: int = 4):
    """Apply n:m masks to every prunable weight (2-D, last dim % m == 0,
    named ``*weight``), in place, and remember them (reference asp.py
    prune_model). Returns the masks."""
    masks: Dict[str, torch.Tensor] = {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            if not _prunable(name, p, m):
                continue
            mask = compute_nm_mask(p, n, m)
            p.mul_(mask.to(p.dtype))
            masks[name] = mask
    _MASKS[id(model)] = masks
    return masks


def prune_params(params: Dict[str, torch.Tensor], n: int = 2, m: int = 4):
    """Prune a name -> tensor mapping (a trainer's parameters) mid-training.
    Returns (new_params, masks). With the value-derived masking in
    :func:`decorate`, the new zeros stay from the next step on."""
    masks: Dict[str, torch.Tensor] = {}
    out = dict(params)
    for name, v in params.items():
        v = _as_tensor(v)
        if not (v.dim() == 2 and v.shape[-1] % m == 0
                and name.endswith("weight")):
            continue
        mask = compute_nm_mask(v, n, m)
        out[name] = v * mask.to(v.dtype)
        masks[name] = mask
    return out, masks


def decorate(optimizer, model, n: int = 2, m: int = 4):
    """Wrap the optimizer so every step re-applies the pruning masks
    (reference asp.py decorate: masked params stay masked through
    training; the gradients may be dense, the update is re-projected).

    The mask is DERIVED from the incoming parameter values inside the
    step (the zeros of an already n:m-sparse weight stay zero), never read
    from the masks ``prune_model`` stored, so it holds whether
    ``prune_model`` ran before or after ``decorate``, for the eager
    ``step()`` and inside ``ParallelTrainer``'s step alike, and reads no
    host value. A weight that is not n:m sparse (dense, not pruned)
    passes through. As in the reference, an exactly-zero element of a
    weight whose every m-group satisfies the pattern counts as pruned:
    a kept weight whose update lands on 0.0 joins the mask."""
    orig = optimizer.apply_gradients
    # which params are prunable is static (names and shapes at decorate
    # time): the trainer's keys are the names, the eager step's the
    # optimizer's own keys (names, or positions in its parameter list)
    named = [(name, p) for name, p in model.named_parameters()
             if _prunable(name, p, m)]
    prunable = {name for name, _ in named}
    ids = {id(p) for _, p in named}
    for key, p in (getattr(optimizer, "_parameter_list", None)
                   or {}).items():
        if id(p) in ids:
            prunable.add(key)

    def apply_gradients(params, grads, state, lr=None, lr_scales=None,
                        **kw):
        new_p, new_s = orig(params, grads, state, lr=lr,
                            lr_scales=lr_scales, **kw)
        for k in prunable:
            if k not in new_p or k not in params:
                continue
            w = params[k]
            if w.shape[-1] % m:
                continue        # a slice of the weight, not its groups
            groups = (w.reshape(-1, m) != 0).sum(dim=-1)
            is_pruned = (groups <= n).all()
            mask = (w != 0).to(new_p[k].dtype)
            new_p[k] = torch.where(is_pruned, new_p[k] * mask, new_p[k])
        return new_p, new_s

    optimizer.apply_gradients = apply_gradients
    return optimizer


def reset(model):
    _MASKS.pop(id(model), None)
