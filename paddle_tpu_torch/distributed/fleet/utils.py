"""``recompute``, ``checkpoint_policy`` and ``fused_allreduce_gradients``.

Port of ``paddle_tpu/distributed/fleet/utils.py``.

- ``recompute(function, *args)`` runs ``function`` under
  ``torch.utils.checkpoint`` (non-reentrant): activations are dropped and
  recomputed in the backward. The port's dropout draws from its own
  device generator, which ``checkpoint`` does not restore, so the call is
  wrapped as the trainer's remat wraps the model (the generator is put
  back to its forward state for the recompute).
- ``checkpoint_policy(name)``: the reference maps names onto
  ``jax.checkpoint_policies``; the port maps them onto selective
  activation checkpointing (``torch.utils.checkpoint.
  create_selective_checkpoint_contexts``), whose policy sees each ATen op
  of the segment's forward and says whether its output is kept or
  recomputed. ``None`` and ``"full"`` recompute the whole segment (plain
  ``checkpoint``, no policy); ``"dots_saveable"`` keeps the outputs of
  ``mm``, ``addmm``, ``bmm`` and ``baddbmm``;
  ``"dots_with_no_batch_dims_saveable"`` those of ``mm`` and ``addmm``;
  ``"nothing_saveable"`` keeps nothing, as ``"full"``; and
  ``"everything_saveable"`` keeps every op's output. ``recompute`` also
  takes a policy function of that API (``policy_fn(ctx, op, *args,
  **kwargs) -> CheckpointPolicy``), as the reference takes a jax policy.
  The port's CUDA kernels (flash attention, fused CE) run inside
  ``autograd.Function``s through ctypes: the policy sees the tensors
  they allocate, not the kernels, so under every policy their launches
  run again in the recompute.
- ``fused_allreduce_gradients(grads, ...)``: the bucketed mean of a grads
  tree over the data axes through ``compressed.compressed_tree_mean``,
  eager on each rank; the identity where no mesh holds the axes.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Union

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..compressed import compressed_tree_mean
from ..mesh import get_mesh

__all__ = ["recompute", "checkpoint_policy", "fused_allreduce_gradients"]

_aten = torch.ops.aten
_DOTS = frozenset((_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm))
_DOTS_NO_BATCH = frozenset((_aten.mm, _aten.addmm))


def _saving(ops: Optional[frozenset]):
    """A policy function keeping the outputs of ``ops`` (every op's when
    None) and recomputing the rest."""
    def policy_fn(ctx, op, *args, **kwargs):
        keep = ops is None or getattr(op, "_overloadpacket", None) in ops
        return (CheckpointPolicy.PREFER_SAVE if keep
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return policy_fn


_POLICIES = {
    None: None,
    "full": None,                      # keep nothing: recompute everything
    "dots_saveable": _saving(_DOTS),
    "dots_with_no_batch_dims_saveable": _saving(_DOTS_NO_BATCH),
    "nothing_saveable": _saving(frozenset()),
    "everything_saveable": _saving(None),
}


def checkpoint_policy(name: Optional[str]):
    """The policy function of a name (None for ``None`` and ``"full"``,
    the whole-segment recompute); an unknown name raises ValueError."""
    try:
        return _POLICIES[name]
    except KeyError:
        raise ValueError(f"unknown checkpoint policy {name!r}; one of "
                         f"{sorted(k for k in _POLICIES if k)}") from None


def recompute(function: Callable, *args, preserve_rng_state: bool = True,
              policy: Union[str, Callable, None] = None, **kwargs):
    """``function(*args, **kwargs)`` with its activations recomputed in the
    backward, all of them or, under ``policy`` (a name of
    :func:`checkpoint_policy` or a policy function), those the policy does
    not keep."""
    from ..engine import _RngReplay
    pol = checkpoint_policy(policy) if isinstance(policy, (str, type(None))) \
        else policy
    lead = next((a for a in args if isinstance(a, torch.Tensor)), None)
    fn = (lambda *a: function(*a, **kwargs))
    if preserve_rng_state and lead is not None:
        fn = _RngReplay(fn, lead.device)
    if pol is None:
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=functools.partial(
                          create_selective_checkpoint_contexts, pol))


def fused_allreduce_gradients(grads, hcg=None, axes=("data", "sharding"),
                              grad_sync="fp32", block=None,
                              bucket_bytes: int = 4 << 20, residuals=None,
                              mesh=None):
    """Mean of a grads tree over the data axes present in the mesh; the
    quantized policies take and return ``residuals`` (then the return is
    ``(grads, new_residuals)``)."""
    mesh = mesh if mesh is not None else get_mesh()
    live = tuple(ax for ax in axes
                 if mesh is not None and ax in mesh.axis_names)
    if not live:
        return grads if residuals is None else (grads, residuals)
    grads, new_res = compressed_tree_mean(
        grads, live, policy=grad_sync, block=block,
        bucket_bytes=bucket_bytes, residuals=residuals, mesh=mesh)
    return grads if residuals is None else (grads, new_res)
