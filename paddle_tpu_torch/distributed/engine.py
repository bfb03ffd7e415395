"""``ParallelTrainer`` on one device.

Port of ``paddle_tpu/distributed/engine.py``'s trainer for the
single-device path. ``train_step(inputs, labels)`` runs
``loss_fn(model(inputs), labels)``, its backward, and the optimizer's
``apply_gradients`` with the in-step NaN guard:

- one fused all-finite reduction over the gradients
  (``resilience/guard.py``) decides, through ``torch.where`` on the device,
  whether the new parameters, optimizer slots and step count replace the
  old ones, and bumps a device ``skipped`` counter when they do not. No
  host sync; a non-finite step leaves every piece of state as it was.
- ``grad_taint`` multiplies the first gradient (in parameter order) by a
  scalar, the reference's fault-injection operand: NaN poisons the step.

The model's parameters ARE the trainer's state: the trainer moves the
model (and makes the optimizer state) on its device and updates the
parameters in place, where the reference keeps donated copies. A
parameter that gets no gradient is left as it was.

Two knobs of the reference's single-device step:

- ``remat=True`` runs the model call under
  ``torch.utils.checkpoint.checkpoint(use_reentrant=False)`` and keeps only
  its output, as the reference wraps it in ``jax.checkpoint``. The port's
  dropout masks and flash dropout seeds come from its own per-device
  generator (``framework/random.py``), which ``checkpoint`` does not
  restore; :class:`_RngReplay` puts that generator back to its state at
  the forward for the recompute, then returns it to where the step had
  left it, so the recompute draws the same masks and seeds.
- ``accumulate_steps=K`` (gradient merge) splits every input and label
  tensor along dim 0 into K sequential chunks, runs forward and backward
  per chunk, and averages the losses and the gradients, as the reference
  does; a batch that does not divide by K raises ``ValueError``. The
  reference splits one dropout key K ways; here the chunks draw one after
  another from the device generator, so each chunk gets fresh masks.

``train_step(lr=None)`` takes ``optimizer.get_lr()``, an ``LRScheduler``'s
value when the optimizer has one.

``device=None`` means the card; without one the trainer raises unless
``device="cpu"`` is passed. Data parallelism (``mesh``), ``grad_sync``
policies other than fp32, ZeRO (``zero_stage``), pipeline micro-batches
and loss scaling (``scaler``) wait in ``ROADMAP.md`` (Queue 1) and raise
``NotImplementedError``.

With telemetry on, each step records ``step_time_seconds`` (wall time
synced on the device) and ``tokens_per_sec`` (the lead input's first two
dims over that time).
"""
from __future__ import annotations

import time
from collections import OrderedDict
from typing import Callable, Optional, Union

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import telemetry as _telemetry
from .._device import resolve_device
from ..framework.random import get_generator
from ..resilience.guard import all_finite

__all__ = ["ParallelTrainer"]


def _waits(what: str, item: str):
    raise NotImplementedError(
        f"ParallelTrainer: {what} is not ported yet; it waits in ROADMAP.md "
        f"(Queue 1, {item})")


def _to_device(x, device):
    """numpy arrays, tensors, and tuples/lists of them -> tensors on
    ``device``; other leaves (floats, None) pass through."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)
    if isinstance(x, (tuple, list)):
        return type(x)(_to_device(v, device) for v in x)
    return x


def _lead(x):
    """The first tensor of ``inputs`` (depth first), or None."""
    if isinstance(x, torch.Tensor):
        return x
    for v in x if isinstance(x, (tuple, list)) else ():
        t = _lead(v)
        if t is not None:
            return t
    return None


def _split(x, k):
    """Every tensor of ``x`` (nested tuples/lists) with a leading dim cut
    into ``k`` chunks along dim 0 -> a list of ``k`` such structures; other
    leaves are repeated."""
    if isinstance(x, torch.Tensor) and x.dim() > 0:
        return list(torch.chunk(x, k, dim=0))
    if isinstance(x, (tuple, list)):
        parts = [_split(v, k) for v in x]
        return [type(x)(p[i] for p in parts) for i in range(k)]
    return [x] * k


class _RngReplay:
    """Wraps the model call checkpointed by remat: the first call records
    the device generator's state; the recompute runs from that state and
    then gives the generator back the state it found."""

    def __init__(self, fn, device):
        self.fn = fn
        self.gen = get_generator(device)
        self.state = None

    def __call__(self, *args):
        if self.state is None:
            self.state = self.gen.get_state()
            return self.fn(*args)
        now = self.gen.get_state()
        self.gen.set_state(self.state)
        try:
            return self.fn(*args)
        finally:
            self.gen.set_state(now)


class ParallelTrainer:
    """model: a Layer; optimizer: an ``Optimizer``; loss_fn(outputs, labels)
    -> scalar."""

    def __init__(self, model, optimizer, loss_fn: Callable, mesh=None,
                 micro_batches: int = 1, remat: bool = False,
                 zero_stage: int = 0, accumulate_steps: int = 1,
                 fp16_allreduce: bool = False,
                 grad_sync: Optional[str] = None,
                 nan_guard: bool = True, scaler=None,
                 device: Optional[Union[str, torch.device]] = None):
        if mesh is not None:
            _waits("a device mesh (data parallelism)",
                   "data parallelism over torch.distributed")
        if fp16_allreduce or grad_sync not in (None, "fp32"):
            _waits(f"grad_sync={grad_sync or 'bf16'}",
                   "data parallelism over torch.distributed")
        if zero_stage:
            _waits(f"zero_stage={zero_stage}",
                   "data parallelism over torch.distributed")
        if micro_batches > 1:
            _waits(f"micro_batches={micro_batches}", "pipeline parallelism")
        if accumulate_steps < 1:
            raise ValueError(f"accumulate_steps must be >= 1, got "
                             f"{accumulate_steps}")
        if scaler is not None:
            _waits("a loss scaler", "AMP GradScaler")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.nan_guard = nan_guard
        self.remat = bool(remat)
        self.accumulate_steps = int(accumulate_steps)
        self.params = OrderedDict((n, p) for n, p in model.named_parameters()
                                  if p.requires_grad)
        self.opt_state = optimizer.init_state(
            {n: p.detach() for n, p in self.params.items()})
        self.skipped = torch.zeros((), dtype=torch.int32, device=self.device)

    def train_step(self, inputs, labels, lr: Optional[float] = None,
                   grad_taint: Optional[float] = None) -> torch.Tensor:
        """One step; returns the 0-d loss on the device (no host sync
        unless telemetry is on)."""
        lr = self.optimizer.get_lr() if lr is None else lr
        k = self.accumulate_steps
        tel = _telemetry.enabled()
        t0 = time.perf_counter() if tel else 0.0
        inputs = _to_device(inputs, self.device)
        labels = _to_device(labels, self.device)
        lead = _lead(inputs)
        if k > 1 and lead is not None and lead.dim() and lead.shape[0] % k:
            raise ValueError(f"batch size {lead.shape[0]} is not divisible "
                             f"by accumulate_steps={k}")
        names = list(self.params)
        if k > 1:
            # gradient merge: the mean of K sequential chunks' losses and
            # gradients (the reference sums l_i / K, then the grads / K)
            loss, grads = 0.0, None
            for ins, lbs in zip(_split(inputs, k), _split(labels, k)):
                l_i, g_i = self._grads(names, ins, lbs)
                loss = loss + l_i / k
                grads = g_i if grads is None else [
                    a if b is None else (b if a is None else a + b)
                    for a, b in zip(grads, g_i)]
            grads = [None if g is None else g / k for g in grads]
        else:
            loss, grads = self._grads(names, inputs, labels)
        grads = dict(zip(names, grads))
        if grad_taint is not None and names and grads[names[0]] is not None:
            grads[names[0]] = grads[names[0]] * grad_taint
        with torch.no_grad():
            old = {n: p.detach() for n, p in self.params.items()}
            new_params, new_opt = self.optimizer.apply_gradients(
                old, grads, self.opt_state, lr=lr)
            if self.nan_guard:
                finite = all_finite(g for g in grads.values()
                                    if g is not None)
                new_params = {n: torch.where(finite, v, old[n])
                              for n, v in new_params.items()}
                new_opt = _keep(finite, new_opt, self.opt_state)
                self.skipped += (~finite).to(torch.int32)
            for n, p in self.params.items():
                p.copy_(new_params[n])
            self.opt_state = new_opt
        loss = loss.detach()
        if tel:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._record_step_telemetry(time.perf_counter() - t0, inputs)
        return loss

    def _grads(self, names, inputs, labels):
        """(loss, grads in ``names`` order) of one forward and backward."""
        if self.remat:
            out = checkpoint(_RngReplay(self.model, self.device), inputs,
                             use_reentrant=False)
        else:
            out = self.model(inputs)
        loss = self.loss_fn(out, labels)
        grads = torch.autograd.grad(loss, [self.params[n] for n in names],
                                    allow_unused=True)
        return loss, list(grads)

    def _record_step_telemetry(self, dt, inputs):
        _telemetry.histogram(
            "step_time_seconds",
            "train_step wall time incl. device execution").observe(dt)
        lead = _lead(inputs)
        if lead is None or lead.dim() == 0 or dt <= 0:
            return
        tokens = lead.shape[0] * (lead.shape[1] if lead.dim() >= 2 else 1)
        _telemetry.gauge(
            "tokens_per_sec",
            "elements of the lead input's first two dims per second"
        ).set(tokens / dt)

    def skipped_steps(self) -> int:
        """Steps the NaN guard skipped so far (one host sync)."""
        return int(self.skipped.item())

    def get_param(self, name) -> torch.Tensor:
        return self.params[name].detach()

    def set_param(self, name, value):
        with torch.no_grad():
            p = self.params[name]
            p.copy_(torch.as_tensor(value).to(p.dtype))

    def get_opt_slot(self, name, slot) -> Optional[torch.Tensor]:
        return self.opt_state["slots"].get(name, {}).get(slot)


def _keep(finite, new, old):
    """torch.where(finite, new, old) over a nested dict of tensors."""
    if isinstance(new, dict):
        return {k: _keep(finite, v, old[k]) for k, v in new.items()}
    return torch.where(finite, new, old)
