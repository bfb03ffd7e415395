"""``recompute``, ``checkpoint_policy`` and ``fused_allreduce_gradients``.

Port of ``paddle_tpu/distributed/fleet/utils.py``.

- ``recompute(function, *args)`` runs ``function`` under
  ``torch.utils.checkpoint`` (non-reentrant): activations are dropped and
  recomputed in the backward. The port's dropout draws from its own
  device generator, which ``checkpoint`` does not restore, so the call is
  wrapped as the trainer's remat wraps the model (the generator is put
  back to its forward state for the recompute).
- ``checkpoint_policy(name)``: the reference maps names onto
  ``jax.checkpoint_policies``. The port recomputes the whole segment,
  which is the policies ``None`` and ``"full"``; the others raise
  ``NotImplementedError``.
- ``fused_allreduce_gradients(grads, ...)``: the bucketed mean of a grads
  tree over the data axes through ``compressed.compressed_tree_mean``,
  eager on each rank; the identity where no mesh holds the axes.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..compressed import compressed_tree_mean
from ..mesh import get_mesh

__all__ = ["recompute", "checkpoint_policy", "fused_allreduce_gradients"]

_POLICIES = ("dots_saveable", "dots_with_no_batch_dims_saveable",
             "nothing_saveable", "everything_saveable")


def checkpoint_policy(name: Optional[str]):
    """None for the whole-segment recompute (``None`` or ``"full"``)."""
    if name in (None, "full"):
        return None
    if name in _POLICIES:
        raise NotImplementedError(
            f"checkpoint policy {name!r} is not ported: the port recomputes "
            f"the whole segment (policy None or 'full')")
    raise ValueError(f"unknown checkpoint policy {name!r}; one of "
                     f"{sorted(_POLICIES + ('full',))}")


def recompute(function: Callable, *args, preserve_rng_state: bool = True,
              policy: Optional[str] = None, **kwargs):
    """``function(*args, **kwargs)`` with its activations recomputed in the
    backward."""
    from ..engine import _RngReplay
    checkpoint_policy(policy)
    lead = next((a for a in args if isinstance(a, torch.Tensor)), None)
    fn = (lambda *a: function(*a, **kwargs))
    if preserve_rng_state and lead is not None:
        fn = _RngReplay(fn, lead.device)
    return checkpoint(fn, *args, use_reentrant=False)


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
