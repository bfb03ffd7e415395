"""``ParallelTrainer``: one device, or data parallelism over
``torch.distributed``.

Port of ``paddle_tpu/distributed/engine.py``'s trainer for the
single-device and data-parallel paths. ``train_step(inputs, labels)``
runs ``loss_fn(model(inputs), labels)``, its backward, the gradient
exchange and the optimizer's ``apply_gradients`` with the in-step NaN
guard:

- one fused all-finite reduction over the exchanged gradients
  (``resilience/guard.py``) decides, through ``torch.where`` on the device,
  whether the new parameters, optimizer slots, step count and error-feedback
  residuals replace the old ones, and bumps a device ``skipped`` counter
  when they do not. No host sync; a non-finite step leaves every piece of
  state as it was.
- ``grad_taint`` multiplies one gradient (the first parameter name in
  sorted order, the leaf the reference's sorted dict gives it) by a
  scalar, the reference's fault-injection operand: NaN poisons the step.

The model's parameters ARE the trainer's state: the trainer moves the
model (and makes the optimizer state) on its device and updates the
parameters in place, where the reference keeps donated copies. A
parameter that gets no gradient is left as it was and takes no part in
the exchange.

**Data parallelism** (``mesh=build_mesh({"data": n})``). One process
drives each card, the PyTorch idiom, where the reference has one
controller for all chips; ``env.init_parallel_env`` starts the process
group, NCCL on the card and gloo on the CPU, and the trainer raises when
the mesh's backend is not its device's (no silent fallback). Every rank
calls ``train_step`` with the same global batch and takes its slice along
dim 0; the loss is averaged over the ranks (the reference's ``pmean``), so
every rank returns the global mean. The replicas must start equal
(``parallel.sync_params_buffers``, or the same seed).

The gradients are averaged through ``compressed.py``'s bucketed exchange
under ``grad_sync``:

- ``"fp32"`` exact, ``"bf16"`` through bfloat16, ``"int8"``/``"int4"`` the
  two-phase block-scaled exchange with per-rank error-feedback residuals
  (``comm_err``: one float32 tensor per parameter, this rank's row of the
  reference's replica-major state). Resolution, as the reference: the
  argument, else the model's ``grad_sync`` attribute (``DataParallel``,
  with its block and bucket bytes), else ``"bf16"`` under
  ``fp16_allreduce``, else ``"fp32"``.
- The quantized policies run at any world size, one rank included (the
  quantize/dequantize round trip and the residual update are the same);
  fp32 and bf16 skip the axes of one rank.
- ``grad_sync_dcn_only`` quantizes only over axes whose link is ``"dcn"``
  (``mesh.axis_links``); the others stay fp32.
- ``grad_sync_buckets=K`` > 1 splits the parameters into K byte-balanced
  buckets in reverse layer order (:func:`partition_reverse_buckets`,
  bucket 0 holds the last layers) and issues each bucket's exchange
  inside the backward, from tensor hooks, as soon as its last gradient
  exists. Buckets are issued in index order on every rank (a bucket that
  is ready early waits for the ones before it), so the collectives match
  across ranks; a bucket with an unused parameter is issued once the
  backward ends. The last collective of each bucket is asynchronous and
  is waited for before the optimizer.
- Under gradient merge (``accumulate_steps=K``) every chunk is exchanged,
  and the residuals thread through the chunks, as in the reference.

**Loss scaling** (``scaler=amp.GradScaler(...)``): the loss is scaled
before the backward, the gradients are unscaled before their exchange
(inside each bucket's when buckets > 1), and the scale state (on the
device) is updated from the NaN guard's finite flag: a non-finite step is
skipped and the scale drops in the same step.

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
  does; a batch that does not divide by K (times the data ranks) raises
  ``ValueError``. The reference splits one dropout key K ways; here the
  chunks draw one after another from the device generator, so each chunk
  gets fresh masks.

``train_step(lr=None)`` takes ``optimizer.get_lr()``, an ``LRScheduler``'s
value when the optimizer has one.

``device=None`` means the card; without one the trainer raises unless
``device="cpu"`` is passed. ZeRO (``zero_stage``), pipeline
micro-batches, the integrity check and any mesh axis but ``data`` wait in
``ROADMAP.md`` (Queue 1) and raise ``NotImplementedError``.

**State and checkpoints.** :attr:`ParallelTrainer.state` is the
reference's ``trainer.state`` over the live tensors (parameters, buffers,
optimizer state, residuals, NaN guard and loss scale); assigning to it
copies a restored state in place. ``save_checkpoint``/``load_checkpoint``
write and read it through ``distributed/checkpoint.py`` (one rank; more
raise), and ``CheckpointManager.save(step, trainer.state)`` /
``trainer.state = manager.restore(template=trainer.state)`` resume a run
bit for bit. The optimizer state lives on the optimizer
(``optimizer.state``), so ``optimizer.state_dict()`` holds it.

While the profiler is on (``profiler.start_profiler``), each step is a
``train_step`` host range, synced on the device.

With telemetry on, each step records ``step_time_seconds`` (wall time
synced on the device), ``tokens_per_sec`` (the lead input's first two dims
over that time) and, where the exchange moves data (more than one rank),
``grad_sync_bytes_total{policy,link,bucket}`` (the ring model of
``compressed.tree_wire_bytes``), ``grad_sync_compression_x`` (fp32 bytes
over the policy's) and ``grad_sync_residual_norm``.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from typing import Callable, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from .. import profiler as _profiler
from .. import telemetry as _telemetry
from .._device import resolve_device
from ..framework.random import get_generator
from ..resilience.guard import all_finite
from .compressed import (QUANTIZED_POLICIES, div_const,
                         normalize_axis_policies, residual_norm,
                         start_tree_mean, tree_wire_bytes)
from .env import backend_for
from .mesh import axis_links, require_mesh

__all__ = ["ParallelTrainer", "partition_reverse_buckets"]

DATA_AXES = ("data", "sharding")   # the batch splits over both (ZeRO within DP)


def _waits(what: str, item: str):
    raise NotImplementedError(
        f"ParallelTrainer: {what} is not ported yet; it waits in ROADMAP.md "
        f"(Queue 1, {item})")


def partition_reverse_buckets(items, k: int):
    """Partition ``items`` ([(key, nbytes)] in forward layer order) into at
    most ``k`` byte-balanced buckets in REVERSE order: bucket 0 holds the
    last layers, whose grads exist first in the backward. Returns a list
    of non-empty key lists."""
    items = list(items)
    k = max(1, min(int(k), len(items)))
    total = float(sum(b for _, b in items)) or 1.0
    target = total / k
    buckets, cur, acc = [], [], 0.0
    rev = list(reversed(items))
    for i, (key, b) in enumerate(rev):
        cur.append(key)
        acc += float(b)
        left = len(rev) - i - 1
        need = k - 1 - len(buckets)  # buckets still owed after this one
        if need > 0 and (left == need or (acc >= target and left >= need)):
            buckets.append(cur)
            cur, acc = [], 0.0
    if cur:
        buckets.append(cur)
    return buckets


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


def _shard(x, n, rank):
    """This data rank's slice along dim 0 of every tensor of ``x`` with a
    leading dim (the reference's P("data") leaf spec); 0-d tensors and
    other leaves are replicated."""
    if n == 1:
        return x
    if isinstance(x, torch.Tensor) and x.dim() > 0:
        if x.shape[0] % n:
            raise ValueError(f"batch dim {x.shape[0]} is not divisible by "
                             f"the {n} data ranks")
        c = x.shape[0] // n
        return x[rank * c:(rank + 1) * c]
    if isinstance(x, (tuple, list)):
        return type(x)(_shard(v, n, rank) for v in x)
    return x


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


class _BucketHooks:
    """Issues each bucket's exchange from tensor hooks during one backward,
    in bucket order; :meth:`finish` issues what is left and waits."""

    def __init__(self, trainer, names):
        self.tr = trainer
        self.grads = {}
        self.left = []
        self.bucket_of = {}
        for b, keys in enumerate(trainer.grad_sync_bucket_keys):
            self.left.append(len(keys))
            for k in keys:
                self.bucket_of[k] = b
        self.ready = set()
        self.next = 0
        self.finishers = []
        self.handles = [trainer.params[k].register_hook(
            lambda g, k=k: self._on_grad(k, g)) for k in names
            if k in self.bucket_of]

    def _on_grad(self, key, g):
        self.grads[key] = g
        b = self.bucket_of[key]
        self.left[b] -= 1
        if self.left[b] == 0:
            self.ready.add(b)
            while self.next in self.ready:
                self._issue(self.next)
        return None

    def _issue(self, b):
        keys = self.tr.grad_sync_bucket_keys[b]
        sub = {k: self.grads[k] for k in keys if self.grads.get(k) is not None}
        self.finishers.append(self.tr._start_exchange(sub))
        self.next += 1

    def finish(self, grads: dict):
        """Issue the buckets not issued yet (from ``grads``, the backward's
        result) and wait for all -> (means, new residuals) by name."""
        for h in self.handles:
            h.remove()
        self.grads = grads
        while self.next < len(self.tr.grad_sync_bucket_keys):
            self._issue(self.next)
        means, res = {}, {}
        for fin in self.finishers:
            m, r = fin()
            means.update(m)
            res.update(r or {})
        return means, res


class ParallelTrainer:
    """model: a Layer; optimizer: an ``Optimizer``; loss_fn(outputs, labels)
    -> scalar (the mean over the local batch)."""

    def __init__(self, model, optimizer, loss_fn: Callable, mesh=None,
                 micro_batches: int = 1, remat: bool = False,
                 zero_stage: int = 0, accumulate_steps: int = 1,
                 fp16_allreduce: bool = False,
                 grad_sync: Optional[str] = None,
                 grad_sync_block: Optional[int] = None,
                 grad_sync_bucket_bytes: int = 4 << 20,
                 grad_sync_buckets: int = 1,
                 grad_sync_dcn_only: Optional[bool] = None,
                 nan_guard: bool = True, integrity_check_every: int = 0,
                 scaler=None,
                 device: Optional[Union[str, torch.device]] = None):
        if zero_stage:
            _waits(f"zero_stage={zero_stage}", "items 14 and 15: ZeRO "
                   "sharding and compressed_psum_scatter in the engine")
        if micro_batches > 1:
            _waits(f"micro_batches={micro_batches}", "pipeline parallelism")
        if integrity_check_every:
            _waits("integrity_check_every", "the replica integrity check")
        if accumulate_steps < 1:
            raise ValueError(f"accumulate_steps must be >= 1, got "
                             f"{accumulate_steps}")
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else require_mesh()
        backend = self.mesh.backend()
        if backend is not None and backend != backend_for(self.device):
            raise RuntimeError(
                f"ParallelTrainer: the mesh's process group is {backend} but "
                f"the trainer runs on {self.device}; use "
                f"{backend_for(self.device)} for it")
        self.n_data = self.mesh.shape["data"]
        self.data_rank = self.mesh.rank_in("data")
        self.model = model.to(self.device)
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.nan_guard = nan_guard
        self.remat = bool(remat)
        self.accumulate_steps = int(accumulate_steps)
        self.scaler = scaler if (scaler is not None
                                 and scaler.is_enable()) else None
        # exchange policy, resolved as the reference resolves it
        if grad_sync is None:
            grad_sync = getattr(model, "grad_sync", None)
            if grad_sync is not None:
                grad_sync_block = getattr(model, "grad_sync_block",
                                          grad_sync_block)
                grad_sync_bucket_bytes = getattr(
                    model, "grad_sync_bucket_bytes", grad_sync_bucket_bytes)
        if grad_sync_dcn_only is None:
            grad_sync_dcn_only = bool(getattr(model, "grad_sync_dcn_only",
                                              False))
        if grad_sync is None:
            grad_sync = "bf16" if fp16_allreduce else "fp32"
        normalize_axis_policies("data", grad_sync)        # validates
        self.grad_sync = grad_sync
        self.grad_sync_block = grad_sync_block
        self.grad_sync_bucket_bytes = grad_sync_bucket_bytes
        self.grad_sync_buckets = max(
            1, int(getattr(model, "grad_sync_buckets", grad_sync_buckets)))
        self.grad_sync_dcn_only = grad_sync_dcn_only
        self.fp16_allreduce = fp16_allreduce or grad_sync == "bf16"

        self.params = OrderedDict((n, p) for n, p in model.named_parameters()
                                  if p.requires_grad)
        self.opt_state = optimizer.init_state(
            {n: p.detach() for n, p in self.params.items()})
        self.skipped = torch.zeros((), dtype=torch.int32, device=self.device)
        self.amp = (self.scaler.init_scale_state(self.device)
                    if self.scaler is not None else None)
        self._init_exchange()

    # -- the exchange plan --------------------------------------------------
    def _init_exchange(self):
        mesh = self.mesh
        self.reduce_axes = DATA_AXES
        if self.grad_sync_dcn_only and self.grad_sync in QUANTIZED_POLICIES:
            links = axis_links(mesh)
            self._axis_policy = {
                ax: (self.grad_sync if links.get(ax) == "dcn" else "fp32")
                for ax in self.reduce_axes}
            quantized = any(p in QUANTIZED_POLICIES
                            for p in self._axis_policy.values())
        else:
            self._axis_policy = self.grad_sync
            quantized = self.grad_sync in QUANTIZED_POLICIES
        # per-rank error-feedback residuals: this rank's row of the
        # reference's replica-major comm_err
        self.comm_err = OrderedDict(
            (k, torch.zeros(p.shape, dtype=torch.float32, device=self.device))
            for k, p in self.params.items()) if quantized else OrderedDict()
        # fp32/bf16: one-rank axes are no-ops and are skipped; the
        # quantized policies keep them, so the round trip runs at any size
        self.sync_axes = tuple(ax for ax in self.reduce_axes
                               if quantized or mesh.shape[ax] > 1)
        plain_keys = list(self.params)
        use_buckets = (self.grad_sync_buckets > 1 and bool(self.sync_axes)
                       and len(plain_keys) >= 2)
        bucket_keys = []
        if use_buckets:
            bucket_keys = partition_reverse_buckets(
                [(k, self.params[k].numel() * self.params[k].element_size())
                 for k in plain_keys], self.grad_sync_buckets)
            use_buckets = len(bucket_keys) >= 2
        self.grad_sync_bucket_keys = ([list(b) for b in bucket_keys]
                                      if use_buckets else
                                      ([plain_keys] if plain_keys else []))
        self._use_buckets = use_buckets
        # telemetry: logical wire bytes per rank of one step's exchange,
        # per (policy, link, bucket)
        n_sync = mesh.axes_size(self.sync_axes) if self.sync_axes else 1
        self._wire_parts = []
        self._wire_bytes_per_step = 0.0
        self._wire_fp32_per_step = 0.0
        if plain_keys and n_sync > 1:
            k = self.accumulate_steps
            links = axis_links(mesh)
            params = {n: p.detach() for n, p in self.params.items()}
            for bi, keys in enumerate(self.grad_sync_bucket_keys):
                bparams = {n: params[n] for n in keys}
                for axes_g, pol in normalize_axis_policies(
                        self.sync_axes, self._axis_policy):
                    n_g = mesh.axes_size(axes_g)
                    if n_g <= 1:
                        continue
                    link = ("dcn" if any(links.get(ax) == "dcn"
                                         for ax in axes_g) else "ici")
                    b = k * tree_wire_bytes(bparams, n_g, pol,
                                            block=self.grad_sync_block)
                    self._wire_parts.append((pol, link, str(bi), b))
            self._wire_bytes_per_step = sum(p[3] for p in self._wire_parts)
            self._wire_fp32_per_step = k * tree_wire_bytes(
                params, n_sync, "fp32", block=self.grad_sync_block)

    def _unscale(self, grads: dict) -> dict:
        if self.amp is None:
            return grads
        inv = 1.0 / self.amp["scale"]
        return {k: g * inv.to(g.dtype) for k, g in grads.items()}

    def _start_exchange(self, grads: dict):
        """Unscale ``grads`` (a dict by name) and issue their exchange ->
        a function giving (means, new residuals) by name."""
        grads = self._unscale(grads)
        if not grads:
            return lambda: ({}, {})
        res = {k: self.comm_err[k] for k in grads if k in self.comm_err}
        return start_tree_mean(
            grads, self.sync_axes, policy=self._axis_policy,
            block=self.grad_sync_block,
            bucket_bytes=self.grad_sync_bucket_bytes,
            residuals=res or None, mesh=self.mesh)

    # -- run ----------------------------------------------------------------
    def train_step(self, inputs, labels, lr: Optional[float] = None,
                   grad_taint: Optional[float] = None) -> torch.Tensor:
        """One step; returns the 0-d loss (the mean over every data rank)
        on the device (no host sync unless telemetry is on)."""
        lr = self.optimizer.get_lr() if lr is None else lr
        k = self.accumulate_steps
        tel = _telemetry.enabled()
        t0 = time.perf_counter() if tel else 0.0
        # the host range of the profiler's trace, only while it is on
        ev = (_profiler.RecordEvent("train_step").begin()
              if _profiler.is_profiler_enabled() else None)
        inputs = _to_device(inputs, self.device)
        labels = _to_device(labels, self.device)
        lead = _lead(inputs)
        if k > 1 and lead is not None and lead.dim() and lead.shape[0] % k:
            raise ValueError(f"batch size {lead.shape[0]} is not divisible "
                             f"by accumulate_steps={k}")
        names = list(self.params)
        comm_err0 = self.comm_err
        if k > 1:
            # gradient merge: the mean of K sequential chunks' losses and
            # gradients (the reference sums l_i / K, then the grads / K);
            # each chunk is exchanged, the residuals threading through
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
        tainted = min(names) if names else None
        if grad_taint is not None and tainted is not None and \
                grads[tainted] is not None:
            grads[tainted] = grads[tainted] * grad_taint
        with torch.no_grad():
            old = {n: p.detach() for n, p in self.params.items()}
            new_params, new_opt = self.optimizer.apply_gradients(
                old, grads, self.opt_state, lr=lr)
            if self.nan_guard or self.amp is not None:
                finite = all_finite(g for g in grads.values()
                                    if g is not None)
                if self.nan_guard:
                    new_params = {n: torch.where(finite, v, old[n])
                                  for n, v in new_params.items()}
                    new_opt = _keep(finite, new_opt, self.opt_state)
                    self.comm_err = _keep(finite, self.comm_err, comm_err0)
                    self.skipped += (~finite).to(torch.int32)
                if self.amp is not None:
                    self.amp = self.scaler.update_scale_state(self.amp,
                                                              ~finite)
            for n, p in self.params.items():
                p.copy_(new_params[n])
            self.opt_state = new_opt
        loss = loss.detach()
        if (tel or ev is not None) and self.device.type == "cuda":
            # the documented sync point: the step's wall time and its host
            # range include the device's execution
            torch.cuda.synchronize(self.device)
        if ev is not None:
            ev.end()
        if tel:
            self._record_step_telemetry(time.perf_counter() - t0, inputs)
        return loss

    def _grads(self, names, inputs, labels):
        """(loss, exchanged grads in ``names`` order) of one forward and
        backward on this rank's slice of the batch; updates the residuals."""
        inputs = _shard(inputs, self.n_data, self.data_rank)
        labels = _shard(labels, self.n_data, self.data_rank)
        if self.remat:
            out = checkpoint(_RngReplay(self.model, self.device), inputs,
                             use_reentrant=False)
        else:
            out = self.model(inputs)
        loss = self.loss_fn(out, labels)
        scale = self.amp["scale"] if self.amp is not None else None
        target = loss if scale is None else loss * scale.to(loss.dtype)
        hooks = (_BucketHooks(self, names)
                 if self._use_buckets and torch.is_grad_enabled() else None)
        try:
            raw = torch.autograd.grad(target, [self.params[n] for n in names],
                                      allow_unused=True)
        except BaseException:
            if hooks is not None:
                for h in hooks.handles:
                    h.remove()
            raise
        grads = dict(zip(names, raw))
        live = {n: g for n, g in grads.items() if g is not None}
        if hooks is not None:
            means, res = hooks.finish(live)
        elif self.sync_axes and live:
            means, res = self._start_exchange(live)()
        else:
            means, res = self._unscale(live), {}
        grads.update(means)
        if res:
            self.comm_err = OrderedDict(self.comm_err)
            self.comm_err.update(res)
        loss = loss.detach()
        if self.n_data > 1:       # the reference's pmean over "data"
            loss = loss.clone()
            dist.all_reduce(loss, group=self.mesh.group_of("data"))
            loss = div_const(loss, self.n_data)
        if scale is not None:
            loss = (loss * scale.to(loss.dtype)) * \
                (1.0 / scale).to(loss.dtype)
        return loss, [grads[n] for n in names]

    def _record_step_telemetry(self, dt, inputs):
        _telemetry.histogram(
            "step_time_seconds",
            "train_step wall time incl. device execution").observe(dt)
        lead = _lead(inputs)
        if lead is not None and lead.dim() and dt > 0:
            tokens = lead.shape[0] * (lead.shape[1] if lead.dim() >= 2
                                      else 1)
            _telemetry.gauge(
                "tokens_per_sec",
                "elements of the lead input's first two dims per second"
            ).set(tokens / dt)
        if self._wire_bytes_per_step:
            wire = _telemetry.counter(
                "grad_sync_bytes_total",
                "logical wire bytes per rank of the bucketed grad "
                "exchange, per exchange group")
            for pol, link, bucket, b in self._wire_parts:
                if b:
                    wire.inc(b, policy=pol, link=link, bucket=bucket)
            _telemetry.gauge(
                "grad_sync_compression_x",
                "fp32 wire bytes / policy wire bytes").set(
                    self._wire_fp32_per_step / self._wire_bytes_per_step)
        if self.comm_err:
            _telemetry.gauge(
                "grad_sync_residual_norm",
                "L2 norm of the error-feedback residual").set(
                    residual_norm(dict(self.comm_err)))

    # -- state and checkpoints ----------------------------------------------
    @property
    def opt_state(self):
        """The optimizer state (``step`` and ``slots``), kept on the
        optimizer so that ``optimizer.state_dict()`` holds it."""
        return self.optimizer.state

    @opt_state.setter
    def opt_state(self, value):
        self.optimizer.state = value

    @property
    def state(self) -> dict:
        """The trainer's whole state over its live tensors, the reference's
        ``ParallelTrainer.state``: ``params`` (every model parameter, each
        once), ``buffers`` (the persistent ones), ``opt``, ``comm_err``
        (this rank's residuals) and ``guard`` (``skipped``, and ``amp``
        with a scaler). Assigning a state of the same structure copies it
        into the live tensors in place; a dtype or shape that differs
        raises."""
        params = OrderedDict(self.model.named_parameters())
        seen = {id(p) for p in params.values()}
        buffers = OrderedDict(
            (k, v) for k, v in self.model.state_dict(keep_vars=True).items()
            if id(v) not in seen)
        guard = {"skipped": self.skipped}
        if self.amp is not None:
            guard["amp"] = self.amp
        return {"params": params, "buffers": buffers, "opt": self.opt_state,
                "comm_err": self.comm_err, "guard": guard}

    @state.setter
    def state(self, value: dict):
        _copy_state(self.state, value, "state")

    def _single_rank(self, what):
        if self.n_data > 1:
            _waits(f"{what} of a run over {self.n_data} ranks",
                   "item 15a: checkpoints of per-rank and sharded state")

    def save_checkpoint(self, path: str, use_async: bool = False):
        """Save :attr:`state` as a checkpoint directory
        (``distributed/checkpoint.py``)."""
        from .checkpoint import save_checkpoint as _save
        self._single_rank("save_checkpoint")
        return _save(path, self.state, use_async=use_async)

    def load_checkpoint(self, path: str):
        """Restore :attr:`state` from a checkpoint directory, in place, on
        this trainer's device."""
        from .checkpoint import load_checkpoint as _load
        self._single_rank("load_checkpoint")
        live = self.state
        _copy_state(live, _load(path, template=live), "state")
        return self.state

    def skipped_steps(self) -> int:
        """Steps the NaN guard skipped so far (one host sync)."""
        return int(self.skipped.item())

    def loss_scale(self) -> Optional[float]:
        """The scaler's current loss scale (one host sync), or None."""
        return None if self.amp is None else float(self.amp["scale"])

    def get_param(self, name) -> torch.Tensor:
        return self.params[name].detach()

    def set_param(self, name, value):
        with torch.no_grad():
            p = self.params[name]
            p.copy_(torch.as_tensor(value).to(p.dtype))

    def get_opt_slot(self, name, slot) -> Optional[torch.Tensor]:
        return self.opt_state["slots"].get(name, {}).get(slot)


@torch.no_grad()
def _copy_state(dst, src, path):
    """Copy the tree ``src`` into the live tensors of ``dst`` in place."""
    if isinstance(dst, dict):
        if set(dst) != set(src):
            raise ValueError(f"{path}: keys differ: {sorted(dst)} vs "
                             f"{sorted(src)}")
        for k in dst:
            _copy_state(dst[k], src[k], f"{path}.{k}")
        return
    src = torch.as_tensor(src)
    if src.dtype != dst.dtype or src.shape != dst.shape:
        raise ValueError(f"{path}: {src.dtype} {tuple(src.shape)} does not "
                         f"match the trainer's {dst.dtype} "
                         f"{tuple(dst.shape)}")
    dst.copy_(src)


def _keep(finite, new, old):
    """torch.where(finite, new, old) over a nested dict of tensors."""
    if isinstance(new, dict):
        return type(new)((k, _keep(finite, v, old[k])) for k, v in new.items())
    return torch.where(finite, new, old)
