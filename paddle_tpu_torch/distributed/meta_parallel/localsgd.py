"""LocalSGD and adaptive LocalSGD: k local optimizer steps on each
data-parallel replica with no gradient exchange, then the replicas'
parameters averaged.

Port of ``paddle_tpu/distributed/meta_parallel/localsgd.py`` (reference:
``fleet/meta_optimizers/localsgd_optimizer.py``). The reference stores
every parameter replica-major, a leading replica dim over ``data``,
because GSPMD-replicated parameters cannot diverge, and keeps a
two-program cache so the no-sync program holds no collective. Here each
process IS its replica: the model's parameters are this rank's copy, and
the sync is a host-side branch on ``step_no % k_steps``, every rank
counting alike.

A step takes this rank's slice of the global batch along dim 0 (the
reference's ``P("data")``), runs the forward and backward with no
exchange, and applies the optimizer. Every ``k_steps``-th step then

- averages the parameters over ``data`` through ``compressed_tree_mean``
  under ``param_sync``: ``"fp32"`` the exact mean; otherwise what crosses
  the wire is each rank's DELTA from the anchor (the parameters of the
  last sync, equal on every rank), quantized with this rank's
  error-feedback residual under int8/int4, and the new parameters are
  anchor + the mean delta;
- averages the optimizer's moments exactly (float32), the step counter
  staying shared.

``train_step`` returns the mean loss over the replicas (one scalar
all-reduce: the reference averages its per-replica losses on the host).
``adaptive`` updates ``k_steps`` after every step by the reference's rule
``ceil(sqrt(lr0 · loss / (lr · loss0) · init_k))`` clipped to
``[1, max_k_steps]`` (one host read of the loss a step).
``replica_params(name)`` gathers every replica's copy, ``(n, *shape)``;
``averaged_state_dict()`` is the replicas' mean. ``step_graph(do_sync,
inputs, labels)`` is the sync or the local step traced on fakes of the
state (``analysis/walker.py``; the trainer left as it was), the
reference's ``step_jaxpr``, and ``program_family`` declares the pair.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Callable, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from ..._device import resolve_device
from ..compressed import (DEFAULT_BUCKET_BYTES, GRAD_SYNC_POLICIES,
                          QUANTIZED_POLICIES, all_gather_dim,
                          compressed_tree_mean, div_const, tree_wire_bytes)
from ..env import backend_for
from ..mesh import require_mesh

__all__ = ["LocalSGDTrainer"]


class LocalSGDTrainer:
    """Data-parallel trainer with k local steps and parameter averaging
    (module docstring). ``device=None`` means the card; without one it
    raises unless ``device="cpu"`` is passed."""

    def __init__(self, model, optimizer, loss_fn: Callable, mesh=None,
                 k_steps: int = 1, adaptive: bool = False,
                 init_k_steps: int = 1, max_k_steps: int = 16,
                 param_sync: str = "fp32", param_sync_block=None,
                 param_sync_bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                 device: Optional[Union[str, torch.device]] = None):
        if param_sync not in GRAD_SYNC_POLICIES:
            raise ValueError(f"param_sync {param_sync!r} not in "
                             f"{GRAD_SYNC_POLICIES}")
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else require_mesh()
        backend = self.mesh.backend()
        if backend is not None and backend != backend_for(self.device):
            raise RuntimeError(f"LocalSGDTrainer: the mesh's process group is "
                               f"{backend} but the trainer runs on "
                               f"{self.device}")
        self.model = model.to(self.device)
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.ndata = self.mesh.shape["data"]
        self.data_rank = self.mesh.coord["data"]
        self.adaptive = adaptive
        self.k_steps = init_k_steps if adaptive else k_steps
        self.init_k_steps = init_k_steps
        self.max_k_steps = max_k_steps
        self.param_sync = param_sync
        self.param_sync_block = param_sync_block
        self.param_sync_bucket_bytes = param_sync_bucket_bytes
        self._loss0 = None
        self._lr0 = None
        self._step_no = 0
        self.params = OrderedDict((k, p) for k, p in model.named_parameters()
                                  if p.requires_grad)
        self.opt_state = optimizer.init_state(OrderedDict(
            (k, p.detach()) for k, p in self.params.items()))
        with torch.no_grad():
            self.anchor = (OrderedDict((k, p.detach().clone())
                                       for k, p in self.params.items())
                           if param_sync != "fp32" else OrderedDict())
        self.sync_err = (OrderedDict(
            (k, torch.zeros(p.shape, dtype=torch.float32,
                            device=self.device))
            for k, p in self.params.items())
            if param_sync in QUANTIZED_POLICIES else OrderedDict())

    def _mean(self, tree, policy="fp32", residuals=None):
        return compressed_tree_mean(
            tree, "data", policy=policy, block=self.param_sync_block,
            bucket_bytes=self.param_sync_bucket_bytes, residuals=residuals,
            mesh=self.mesh)

    @torch.no_grad()
    def _sync(self, new_p, new_opt):
        if self.param_sync == "fp32":
            new_p, _ = self._mean(new_p)
        else:
            # plain dicts: flattened in sorted key order, as the
            # reference's, so the blocks hold the same elements
            deltas = {k: v - self.anchor[k] for k, v in new_p.items()}
            mean_d, res = self._mean(deltas, self.param_sync,
                                     dict(self.sync_err) or None)
            new_p = OrderedDict((k, self.anchor[k] + mean_d[k])
                                for k in deltas)
            self.anchor = OrderedDict((k, v.clone())
                                      for k, v in new_p.items())
            if self.sync_err:
                self.sync_err = OrderedDict(res)
        new_opt = dict(new_opt)
        new_opt["slots"], _ = self._mean(new_opt.get("slots", {}))
        return new_p, new_opt

    def sync_wire_bytes(self) -> float:
        """Bytes a rank moves in one sync (the parameters under
        ``param_sync`` and the slots in fp32, ring model; 0 at one rank)."""
        params = {k: p.detach() for k, p in self.params.items()}
        return (tree_wire_bytes(params, self.ndata, self.param_sync,
                                self.param_sync_block)
                + tree_wire_bytes(self.opt_state.get("slots", {}),
                                  self.ndata, "fp32"))

    def train_step(self, inputs, labels, lr: Optional[float] = None):
        from ..engine import _shard, _to_device
        lr = self.optimizer.get_lr() if lr is None else lr
        self._step_no += 1
        do_sync = self._step_no % self.k_steps == 0
        inputs = _shard(_to_device(inputs, self.device), self.ndata,
                        self.data_rank)
        labels = _shard(_to_device(labels, self.device), self.ndata,
                        self.data_rank)
        names = list(self.params)
        loss = self.loss_fn(self.model(inputs), labels)
        grads = torch.autograd.grad(loss, [self.params[k] for k in names],
                                    allow_unused=True)
        with torch.no_grad():
            new_p, new_opt = self.optimizer.apply_gradients(
                OrderedDict((k, self.params[k].detach()) for k in names),
                dict(zip(names, grads)), self.opt_state, lr=lr)
            if do_sync:
                new_p, new_opt = self._sync(new_p, new_opt)
            for k in names:
                self.params[k].copy_(new_p[k])
            self.opt_state = new_opt
            loss = loss.detach().float()
            if self.ndata > 1:
                loss = loss.clone()
                dist.all_reduce(loss, group=self.mesh.group_of("data"))
                loss = div_const(loss, self.ndata)
        if self.adaptive:
            lv = max(float(loss), 1e-12)
            if self._loss0 is None:
                self._loss0, self._lr0 = lv, float(lr)
            self.k_steps = int(np.clip(math.ceil(math.sqrt(
                self._lr0 * lv / (max(float(lr), 1e-12) * self._loss0)
                * self.init_k_steps)), 1, self.max_k_steps))
        return loss

    def replica_params(self, name) -> np.ndarray:
        """Every replica's copy of parameter ``name``, ``(n, *shape)``, in
        rank order (a collective over ``data``); bfloat16 arrives as
        float32 (numpy has no bfloat16)."""
        p = self.params[name].detach()
        out = all_gather_dim(p.unsqueeze(0), "data", 0, mesh=self.mesh)
        return (out.float() if out.dtype == torch.bfloat16
                else out).cpu().numpy()

    def averaged_state_dict(self) -> dict:
        """The replicas' mean of every trainable parameter (a collective
        over ``data``)."""
        out, _ = self._mean(OrderedDict((k, p.detach()) for k, p in
                                        self.params.items()))
        return dict(out)

    _STATE_ATTRS = ("opt_state", "anchor", "sync_err")
    _KEEP_ATTRS = ("_step_no", "k_steps", "adaptive", "_loss0", "_lr0")

    def step_graph(self, do_sync: bool, inputs, labels, lr=None):
        """``train_step`` as the sync (``do_sync=True``) or the local step,
        traced on fakes of the state (nothing launched; the trainer left
        bit for bit as it was): the reference's ``step_jaxpr``
        (``localsgd.py:245``). The adaptive k's host read of the loss is
        no node of a graph: it is off while the step is traced."""
        from ...analysis.walker import trace_program
        from .._staging import bound, state_leaves, tree_leaves
        from ..engine import _to_device
        leaves, _ = state_leaves(self.model, self, self._STATE_ATTRS)

        def step(state, ins, lbs):
            with bound(self.model, self, self._STATE_ATTRS, state,
                       self._KEEP_ATTRS):
                self.adaptive = False
                self.k_steps = 1 if do_sync else 2
                self._step_no = 0
                loss = self.train_step(ins, lbs, lr)
                new = [tree_leaves(getattr(self, a))
                       for a in self._STATE_ATTRS]
            return loss, new

        return trace_program(step, leaves, _to_device(inputs, self.device),
                             _to_device(labels, self.device))

    def program_family(self, inputs, labels):
        """The sync and local steps as a declared
        :class:`~paddle_tpu_torch.analysis.schedule.ProgramFamily`: the
        member is picked by ``step_no % k_steps``, a host counter every
        rank advances alike (the adaptive k derives from the all-reduced
        loss), so the two schedules may differ safely."""
        from ...analysis.schedule import ProgramFamily
        return ProgramFamily(
            name="localsgd-step",
            selector="step_no % k_steps (host-replicated step counter; "
                     "adaptive k derives from the all-reduced loss)",
            rank_invariant=True,
            members={
                "sync": lambda: self.step_graph(True, inputs, labels),
                "no-sync": lambda: self.step_graph(False, inputs, labels)},
            mesh=self.mesh)
