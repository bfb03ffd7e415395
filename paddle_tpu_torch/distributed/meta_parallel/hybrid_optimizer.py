"""``HybridParallelOptimizer`` and ``HybridParallelGradScaler``.

Port of ``paddle_tpu/distributed/meta_parallel/hybrid_optimizer.py``
(reference: ``dygraph_optimizer/hybrid_parallel_optimizer.py:89``). The
wrapper keeps the inner optimizer's whole surface and adds:

- ``sync_gradients(grads)``: the mean over the current mesh's ``data``
  group;
- ``step()``: the eager update, each parameter's ``.grad`` averaged over
  ``data`` first (the mean the reference's ``apply_gradients`` takes).

``ParallelTrainer`` exchanges gradients itself and drives the inner
optimizer, so nothing is averaged twice; it tells the inner optimizer
which gradients are slices (ZeRO slices over ``sharding``,
tensor-parallel slices over ``model``, a stage's members over ``pipe``),
whose norms it sums over those ranks. The eager ``apply_gradients`` and
``step`` tell it the same of every parameter whose ``pspec`` names
``model`` or ``pipe`` on the current mesh (``mesh.split_of``).

``HybridParallelGradScaler.unscale_`` reduces the found-non-finite flag
over every live axis (``all_reduce(MAX)``), so all ranks skip a step
together.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ...optimizer.optimizer import Optimizer
from ..compressed import div_const
from ..mesh import AXES_ORDER, get_mesh, split_of

__all__ = ["HybridParallelOptimizer", "HybridParallelGradScaler"]


def data_mean(grads: dict) -> dict:
    """The mean of each gradient over the current mesh's data group (None
    stays)."""
    group, n = _group(("data",))
    if n == 1:
        return grads
    out = {}
    for k, g in grads.items():
        if g is None:
            out[k] = None
            continue
        s = g.clone()
        dist.all_reduce(s, group=group)
        out[k] = div_const(s, n)
    return out


def _group(axes):
    """(process group, size) of the current mesh's live ``axes``, or
    (None, 1)."""
    mesh = get_mesh()
    if mesh is None or not mesh.live(axes):
        return None, 1
    return mesh.group_of(axes), mesh.axes_size(mesh.live(axes))


class HybridParallelOptimizer:
    def __init__(self, inner_opt: Optimizer, hcg=None, strategy=None):
        self._inner_opt = inner_opt
        self._hcg = hcg
        self._strategy = strategy

    def __getattr__(self, name):
        return getattr(self._inner_opt, name)

    def sync_gradients(self, grads: dict) -> dict:
        """The mean of each gradient over the data group (None stays)."""
        return data_mean(grads)

    def apply_gradients(self, params, grads, state, lr=None, lr_scales=None,
                        split=None):
        grads = self.sync_gradients(grads)
        plist = self._inner_opt._parameter_list or {}
        split = split if split is not None else (
            split_of({k: plist.get(k, v) for k, v in params.items()})
            or None)
        return self._inner_opt.apply_gradients(params, grads, state, lr,
                                               lr_scales, split)

    @torch.no_grad()
    def step(self):
        plist = self._inner_opt._parameter_list or {}
        grads = {k: p.grad for k, p in plist.items()}
        for k, g in self.sync_gradients(grads).items():
            if g is not None:
                plist[k].grad.copy_(g)
        self._inner_opt.step(split=split_of(plist) or None)

    def clear_grad(self):
        self._inner_opt.clear_grad()

    clear_gradients = clear_grad


class HybridParallelGradScaler:
    """reference: ``dygraph_optimizer/hybrid_parallel_gradscaler.py``: the
    found-inf flag is any-reduced across the mesh so that every rank skips
    the step together."""

    def __init__(self, scaler, hcg=None):
        self._scaler = scaler
        self._hcg = hcg

    def __getattr__(self, name):
        return getattr(self._scaler, name)

    @staticmethod
    def _any(found):
        group, n = _group(AXES_ORDER)
        if n == 1:
            return found
        flag = torch.as_tensor(found).to(torch.int32).reshape(())
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
        return flag > 0

    def unscale_(self, grads_or_optimizer):
        """A grads dict: (unscaled, found_inf a 0-d bool tensor); an
        optimizer: whether any rank's gradient is non-finite (a bool)."""
        opt = getattr(grads_or_optimizer, "_inner_opt", grads_or_optimizer)
        if isinstance(opt, dict):
            unscaled, found = self._scaler.unscale_(opt)
            return unscaled, self._any(found)
        found = bool(self._any(self._scaler.unscale_(opt)))
        self._scaler._found_inf = found
        return found

    def step(self, optimizer):
        if not self.unscale_(optimizer):
            optimizer.step()
        self._scaler.update()

    def minimize(self, optimizer, scaled_loss):
        self.step(optimizer)
