"""``ParallelTrainer``: one device, or hybrid parallelism over
``torch.distributed``.

Port of ``paddle_tpu/distributed/engine.py``'s trainer: data parallelism,
ZeRO over ``sharding``, tensor parallelism over ``model``, pipeline
parallelism over ``pipe`` and context parallelism over ``sep``.
``train_step(inputs, labels)``
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

Buffers a training forward replaces (batch norm's running statistics,
named by a layer's ``_stat_buffers``) keep the forward's update, the
eager layer's behaviour; a step the NaN guard skips puts them back with
the parameters. Batch statistics (layers with ``_stat_sync_axes``, the
axes they already agree over) come from each rank's slice of the batch:
after every step the ones the forward replaced are averaged over the
batch's other axes (one float32 all-reduce), so every replica keeps the
same running statistics, which the checkpoint writes once. The
reference's trainer drops these updates (its ``local_loss`` discards the
new buffers, so its running statistics stay at their initial values): an
Oracle caveat (ROADMAP.md).

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
``device="cpu"`` is passed.

**Tensor parallelism** (a ``model`` axis): the Megatron layers
(``meta_parallel/parallel_layers/mp_layers.py``) hold their slices and
issue their own collectives over ``model``; a replicated leaf's gradient
comes out whole and equal on every model rank, and no gradient is
exchanged over ``model``.

**Pipeline parallelism** (a ``pipe`` axis; the model a
``PipelineParallel``): the step runs the pipeline's schedule
(``PipelineParallel.train_batch``, GPipe or 1F1B) over ``micro_batches``
micro-batches (the reference's M; the pipeline's ``accumulate_steps`` is
what its own ``train_batch`` takes when called without one), which
returns the mean loss on every stage and each stage's gradients, the
pipe-replicated ones already summed over ``pipe``. The bucketed exchange
inside the backward is off under a pipeline (the exchange runs after the
schedule); ``remat`` does not apply to it, as in the reference.

**Context parallelism** (a ``sep`` axis): every input and label tensor of
rank >= 2 is split along dim 1 over ``sep`` as well (the model runs ring
attention over it); the loss and the gradients are averaged over
``("data", "sharding", "sep")``, and the error-feedback residual rows run
over those three axes. A pipeline under ``sep`` must decompose as the
reference's ``uniform_split`` does, else it raises as the reference.

On any such mesh the NaN guard's finite flag is reduced over ``model``
and ``pipe`` (and ``sharding`` where a gradient is a ZeRO slice), so
every rank skips alike; the optimizer is told which leaves are slices
(``apply_gradients(split={key: group})``: ZeRO slices over ``sharding``,
tensor-parallel slices over ``model``, stage members over ``pipe``), whose
norms (the clips', Lamb's and Lars's) sum over the group and whose top-k
(DGCMomentum's) is taken over the gathered leaf.

**ZeRO** (``zero_stage=1|2|3`` on a mesh with a ``sharding`` axis of n > 1,
reference ``engine.py:267-415,735-800``; at n = 1 every stage is stage 0,
as the reference gates each at ``n_shard > 1``). The batch splits over
``("data", "sharding")``, data-major: rank (d, s) takes slice
``d * n + s``. A leaf is split where :func:`shard_spec_for` splits it
(leaves under 1024 elements, or with no dim divisible by n, stay whole):

- stage 1: the optimizer slots of a split leaf hold this rank's slice
  (``slot_dims``); the gradients are exchanged as at stage 0; each rank
  updates its slice of the parameter and the new slices are all-gathered
  over ``sharding``.
- stage 2: also the gradients of the split leaves (``zero2_dims``) leave
  the exchange as this rank's slice: a reduce-scatter over ``sharding``
  (``compressed_psum_scatter`` under the quantized policy of that axis,
  with a per-rank, full-tensor error-feedback residual), divided by n,
  then the mean over ``data``. Under ``accumulate_steps`` the sliced
  gradients are what accumulates.
- stage 3: the parameter storage between steps is this rank's slice
  (``zero3_dims``; also every leaf a ``ShardingParallel`` of stage 3 gave a
  ``pspec``). A step all-gathers the slices into the model's parameters,
  reduce-scatters their gradients losslessly in float32 whatever the
  policy (the reference's gather transpose carries no residual), divides
  by n, takes the mean over ``data``, updates the slice and frees the
  full parameters: the model's tensors of those leaves are empty between
  steps (:meth:`ParallelTrainer.sync_to_model` gathers them back).
- the other leaves keep the bucketed exchange over the live axes of
  ``("data", "sharding")``, with the per-axis policy and DCN gating.
- a leaf whose ``pspec`` names ``model`` or ``pipe`` keeps its own split:
  ZeRO splits neither it nor its slots (the reference still splits a
  ``model`` leaf's slots over ``sharding``: memory, not results;
  ROADMAP Queue 3).

**Replica integrity check** (``integrity_check_every=N``). Every N-th
``train_step`` (a host-side cadence, ``_steps_run % N``, as the
reference's) fingerprints the updated ``params``, ``opt`` and
``comm_err`` (``resilience/integrity.py``'s ``fingerprint_array``, the
reference's entry order: each part's leaves in sorted-key order) and
compares the replicated leaves across the live axes of ``("data",
"sharding")`` (and ``sep``): the true replicas. A tensor-parallel slice
or a pipeline stage is compared with the ranks that hold the same slice;
the verdict is spread over ``model`` and ``pipe``, so every rank reads the
same one. The reference emits two scalar collectives a leaf
(``pmin``/``pmax``); the port stacks the fingerprints and issues ONE
``all_reduce(MIN)`` and ONE ``all_reduce(MAX)`` over that group. A leaf
that differs across those ranks by design (its ``comm_err`` rows, a ZeRO
slice of a parameter or a slot) gets the combined digest over the axes it
is split on, an ``all_reduce(SUM)`` taken modulo 2**32 as ``lax.psum``
wraps, and stays out of the equality decision (reference
``engine.py:518-556``). Off-cadence steps compute and issue nothing. A
check step reads the divergence mask on the host (one sync) and records
``last_fingerprints`` (the stacked ``int64`` fingerprints,
``_integrity_entries`` names them), ``last_divergence`` (the diverged
leaves, read and cleared by :meth:`ParallelTrainer.consume_divergence`),
``integrity_check_steps_total`` and ``replica_divergence_total{leaf}``.

:meth:`ParallelTrainer.remesh` moves the trainer onto a new mesh (an
elastic scale-up or scale-down): the optimizer state, residuals, NaN
guard and loss scale start fresh; the parameters are the model's own
tensors and keep their values (the reference re-reads them from the
model too; at stage 3 call :meth:`ParallelTrainer.sync_to_model` on the
old mesh first). Carrying trained state across is
``resilience.elastic.reshard_trainer``'s work.

**State and checkpoints.** :attr:`ParallelTrainer.state` is the
reference's ``trainer.state`` over this rank's live tensors (parameters,
buffers, optimizer state, residuals, NaN guard and loss scale): a ZeRO
leaf is this rank's slice and a residual this rank's row. It is a
:class:`~paddle_tpu_torch.distributed.checkpoint.ShardedState`: a dict
whose ``layout`` places each leaf in its logical array (the reference's
global ``jax.Array``), which the one-directory checkpoint of a world
reads; assigning to it copies a restored state in place.
``save_checkpoint``/``load_checkpoint`` write and read it through
``distributed/checkpoint.py``: over 2+ ranks every rank calls them on
one shared directory, the one directory of the world, each writing the
pieces it owns (a tensor-parallel slice and a stage's members are pieces
too), and a restore onto another ``data`` x ``sharding`` layout takes each
rank's slice from the logical arrays.
``CheckpointManager(dir).save(step, trainer.state)`` / ``trainer.state =
manager.restore(template=trainer.state)`` resume a run bit for bit. The
optimizer state lives on the optimizer (``optimizer.state``), so
``optimizer.state_dict()`` holds it.

While the profiler is on (``profiler.start_profiler``), each step is a
``train_step`` host range, synced on the device.

With telemetry on, each step records ``step_time_seconds`` (wall time
synced on the device), ``tokens_per_sec`` (the lead input's first two dims
over that time) and, where the exchange moves data (more than one rank),
``grad_sync_bytes_total{policy,link,bucket}`` (the ring model of
``compressed.tree_wire_bytes``, over the leaves of the bucketed exchange),
``grad_sync_compression_x`` (fp32 bytes over the policy's) and
``grad_sync_residual_norm``.
"""
from __future__ import annotations

import contextlib
import threading
import time
import weakref
from collections import OrderedDict
from typing import Callable, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.fx.traceback as _fx_traceback
from torch.utils.checkpoint import checkpoint

from .. import profiler as _profiler
from .. import telemetry as _telemetry
from .._device import resolve_device
from ..framework.random import get_generator
from ..resilience.guard import all_finite
from ..resilience.integrity import FINGERPRINT_TAG, _keystr, \
    _leaves_with_path, fingerprint_array
from .checkpoint import Piece, ShardedState
from .compressed import (QUANTIZED_POLICIES, all_gather_dim,
                         compressed_psum_scatter, div_const,
                         normalize_axis_policies, psum_scatter,
                         residual_norm, start_tree_mean, tree_wire_bytes)
from .env import backend_for
from .mesh import (AXES_ORDER, OWN_AXES, axis_links, own_splits,
                   require_mesh, split_of)
from .meta_parallel.pipeline_parallel import PipelineParallel
from .meta_parallel.sharding_parallel import shard_spec_for, spec_dim

__all__ = ["ParallelTrainer", "partition_reverse_buckets"]

DATA_AXES = ("data", "sharding")   # the batch splits over both (ZeRO within DP)


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


def _shard(x, n, rank, dim=0, min_rank=1):
    """This rank's slice along ``dim`` of every tensor of ``x`` of rank
    ``min_rank`` or more (dim 0: the reference's P("data") leaf spec; dim
    1 of rank >= 2: its "sep" sequence split); the other leaves are
    replicated."""
    if n == 1:
        return x
    if isinstance(x, torch.Tensor) and x.dim() >= max(min_rank, dim + 1):
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {x.shape[dim]} is not divisible "
                             f"by the {n} ranks")
        c = x.shape[dim] // n
        return x.narrow(dim, rank * c, c)
    if isinstance(x, (tuple, list)):
        return type(x)(_shard(v, n, rank, dim, min_rank) for v in x)
    return x


def _pipeline_of(model) -> Optional[PipelineParallel]:
    if isinstance(model, PipelineParallel):
        return model
    inner = getattr(model, "_layers", None)
    return inner if isinstance(inner, PipelineParallel) else None


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
    """model: a Layer; optimizer: an ``Optimizer`` (or a
    ``HybridParallelOptimizer``, whose inner optimizer the trainer
    drives); loss_fn(outputs, labels) -> scalar (the mean over the local
    batch)."""

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
        if int(zero_stage) not in (0, 1, 2, 3):
            raise ValueError(f"zero_stage must be 0, 1, 2 or 3, got "
                             f"{zero_stage}")
        if accumulate_steps < 1:
            raise ValueError(f"accumulate_steps must be >= 1, got "
                             f"{accumulate_steps}")
        self.device = resolve_device(device)
        self.pp = _pipeline_of(model)
        self.mesh = mesh if mesh is not None else require_mesh()
        self._token_axes = {getattr(m, "token_axis", None)
                            for m in model.modules()} - {None}
        self._check_mesh(self.mesh)
        self.model = model.to(self.device)
        self.optimizer = optimizer
        self._opt = getattr(optimizer, "_inner_opt", optimizer)
        self.loss_fn = loss_fn
        self.nan_guard = nan_guard
        self.remat = bool(remat)
        self.micro_batches = int(micro_batches)
        self.zero_stage = int(zero_stage)
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
        # the buffers a training forward replaces (batch norm's running
        # statistics): put back when the NaN guard skips the step
        self._stat_owners = [(m, b) for m in model.modules()
                             for b in getattr(m, "_stat_buffers", ())]
        self.integrity_check_every = max(0, int(getattr(
            model, "integrity_check_every", integrity_check_every)))
        self._steps_run = 0
        self._tracing = False
        self._step_cost = None
        self.last_divergence: list = []
        self.last_fingerprints: Optional[torch.Tensor] = None
        # held while a step is issued: layers that write live state between
        # steps from another thread (the heter hot tier) take it too
        self._state_lock = threading.RLock()
        self._setup()
        # layers that manage live training state between steps bind
        # themselves here (reference engine.py:219-226)
        for sub in model.modules():
            hook = getattr(sub, "_on_trainer_built", None)
            if hook is not None:
                hook(self)

    def _check_mesh(self, mesh):
        """The mesh's process group must be of this trainer's device's
        backend (no silent fallback); a ``pipe`` axis needs a pipeline,
        and a pipeline under ``sep`` the reference's decomposable plan."""
        backend = mesh.backend()
        if backend is not None and backend != backend_for(self.device):
            raise RuntimeError(
                f"ParallelTrainer: the mesh's process group is {backend} but "
                f"the trainer runs on {self.device}; use "
                f"{backend_for(self.device)} for it")
        for ax in self._token_axes:
            if mesh.shape[ax] > 1:
                raise ValueError(
                    f"ParallelTrainer: a layer takes its own tokens on each "
                    f"rank of {ax!r} (split_tokens=True), but the trainer "
                    f"gives every rank of it the same batch")
        if mesh.shape["pipe"] > 1 and self.pp is None:
            raise ValueError(
                f"ParallelTrainer: a pipe axis of {mesh.shape['pipe']} needs "
                f"the model wrapped in PipelineParallel")
        if (self.pp is not None and mesh.shape["sep"] > 1
                and self.pp._layers.uniform_split() is None):
            raise NotImplementedError(
                "pipeline + context parallelism ('sep' axis) requires a "
                "plan that decomposes into prologue/stacked-body/epilogue "
                "(PipelineLayer.uniform_split)")

    def _setup(self):
        """Everything that follows the mesh: ranks, the ZeRO plan and
        storage, fresh optimizer state, guard, residuals and the exchange
        and integrity plans."""
        mesh = self.mesh
        self.n_data = mesh.shape["data"]
        self.data_rank = mesh.rank_in("data")
        self.n_shard = mesh.shape["sharding"]
        self.shard_rank = mesh.rank_in("sharding")
        self.n_sep = mesh.shape["sep"]
        # the batch: ("data", "sharding"), data-major
        self.n_batch = self.n_data * self.n_shard
        self.batch_rank = self.data_rank * self.n_shard + self.shard_rank
        # the gradient mean and the residual rows: also over "sep"
        self.reduce_axes = DATA_AXES + (("sep",) if self.n_sep > 1 else ())
        self.n_reduce = mesh.axes_size(self.reduce_axes)
        self.reduce_rank = mesh.rank_in(self.reduce_axes)
        self._init_zero()
        self._init_splits()
        self.opt_state = self._opt.init_state(OrderedDict(
            (k, self._update_view(k)) for k in self.params))
        self.skipped = torch.zeros((), dtype=torch.int32, device=self.device)
        self.amp = (self.scaler.init_scale_state(self.device)
                    if self.scaler is not None else None)
        self._init_exchange()
        self._init_integrity()
        # sharding.save_group_sharded_model gathers the slices through it
        ref = (weakref.ref(self) if self.zero3_dims or self._update_dims
               else None)
        self.model._zero_trainer = self._opt._zero_trainer = ref

    # -- the ZeRO plan --------------------------------------------------------
    def _init_zero(self):
        """Specs and dims as the reference's ``_init_state`` and
        ``_slot_specs`` (``engine.py:267-310,390-415``), and the stage-3
        storage: this rank's slice of each ``zero3_dims`` leaf."""
        n = self.n_shard
        freed = [k for k in getattr(self, "_shards", {})
                 if self.params[k].numel() == 0]
        if freed:
            raise RuntimeError(
                f"ZeRO-3 parameters {freed[:3]} hold no values here; call "
                f"sync_to_model() on the old mesh before remesh")
        self._full_shapes = {}
        self.param_specs = OrderedDict(
            (k, tuple(getattr(p, "pspec", None) or ()))
            for k, p in self.params.items())
        if self.zero_stage >= 3 and n > 1:
            for k, p in self.params.items():
                if all(ax is None for ax in self.param_specs[k]):
                    self.param_specs[k] = shard_spec_for(p, n_shards=n)
        self.zero3_dims = {}
        if n > 1:
            for k, spec in self.param_specs.items():
                d = spec_dim(spec)
                if d is not None:
                    self.zero3_dims[k] = d
        self.zero2_dims = {}
        if self.zero_stage >= 2 and n > 1:
            for k, p in self.params.items():
                if k in self.zero3_dims or any(
                        ax is not None for ax in self.param_specs[k]):
                    continue
                d = spec_dim(shard_spec_for(p, n_shards=n))
                if d is not None:
                    self.zero2_dims[k] = d
        # slot dims: split like shard_spec_for splits each slot at
        # stage >= 1, else following the parameter's own split
        self.slot_dims = OrderedDict()
        self._update_dims = {}
        for k, p in self.params.items():
            shape = self._full_shape(k)
            slots = self._opt.init_slots(
                torch.empty(shape, dtype=p.dtype, device="meta"))
            dims = {}
            own_split = bool(own_splits(getattr(p, "pspec", None)))
            for s, v in slots.items():
                if self.zero_stage >= 1 and n > 1 and not own_split:
                    dims[s] = spec_dim(shard_spec_for(v, n_shards=n))
                else:
                    dims[s] = (self.zero3_dims.get(k)
                               if tuple(v.shape) == shape else None)
            self.slot_dims[k] = dims
            d = self.zero3_dims.get(k, self.zero2_dims.get(k))
            if d is None:
                split = {dd for dd in dims.values() if dd is not None}
                d = split.pop() if len(split) == 1 else None
            for s, dd in dims.items():
                if dd is not None and (dd != d or
                                       tuple(slots[s].shape) != shape):
                    raise NotImplementedError(
                        f"ZeRO: slot {s!r} of {k!r} splits on dim {dd}, "
                        f"its parameter's update on dim {d}")
            if d is not None:
                self._update_dims[k] = d
        # stage-3 storage: this rank's slice, the model's tensor freed
        self._shards = OrderedDict()
        with torch.no_grad():
            for k, d in self.zero3_dims.items():
                p = self.params[k]
                self._shards[k] = self._slice(p.detach(), d).clone()
                self._full_shapes[k] = tuple(p.shape)
                p.data = p.data.new_empty(0)

    def _full_shape(self, k) -> tuple:
        return self._full_shapes.get(k, tuple(self.params[k].shape))

    def _init_splits(self):
        """Each leaf's own split over the live ``pipe``/``model`` axes
        (``self.own_splits[k]``: ((axis, dim), ...)), its logical shape,
        and the group each split leaf's norms and top-k run over
        (``self._split_groups``: ZeRO slices add ``sharding``)."""
        mesh = self.mesh
        self.own_splits = OrderedDict(
            (k, own_splits(getattr(p, "pspec", None), mesh))
            for k, p in self.params.items())
        self._split_groups = split_of(self.params, mesh,
                                      sharded=self._update_dims)
        # the finite flag differs across these ranks where leaves differ
        self._flag_axes = mesh.live(OWN_AXES)

    def _logical_shape(self, k) -> tuple:
        """Leaf ``k``'s whole shape: the ZeRO-3 full shape, times the
        degree of each own split."""
        shape = list(self._full_shape(k))
        for ax, d in self.own_splits.get(k, ()):
            shape[d] *= self.mesh.shape[ax]
        return tuple(shape)

    def _slice(self, x, d):
        """This sharding rank's chunk of ``x`` along ``d``."""
        return torch.chunk(x, self.n_shard, dim=d)[self.shard_rank]

    def _update_view(self, k):
        """The tensor this rank updates for leaf ``k``: its stage-3 slice,
        the slice of the parameter its split slots cover, or all of it."""
        if k in self._shards:
            return self._shards[k]
        p = self.params[k].detach()
        d = self._update_dims.get(k)
        return p if d is None else self._slice(p, d)

    def _gather_params(self):
        """Stage 3: every slice all-gathered into its model parameter."""
        with torch.no_grad():
            for k, d in self.zero3_dims.items():
                self.params[k].data = all_gather_dim(
                    self._shards[k], "sharding", d, mesh=self.mesh)

    def _free_params(self):
        for k in self.zero3_dims:
            p = self.params[k]
            p.data = p.data.new_empty(0)

    def sync_to_model(self):
        """Gather every stage-3 slice into the model's parameters (a
        collective of the sharding group); they stay until the next step
        frees them. The other stages keep the model whole."""
        self._gather_params()

    def consolidated_state(self) -> dict:
        """``{"model": state_dict, "opt": {"state": {"step", "slots"}}}``
        with every ZeRO slice gathered (a collective of the sharding
        group): what one process of stage 0 would hold."""
        self.sync_to_model()
        slots = OrderedDict()
        for k, d in self.opt_state["slots"].items():
            dims = self.slot_dims.get(k, {})
            slots[k] = {s: (all_gather_dim(v, "sharding", dims[s],
                                           mesh=self.mesh)
                            if dims.get(s) is not None
                            and k in self._update_dims else v)
                        for s, v in d.items()}
        return {"model": self.model.state_dict(),
                "opt": {"state": {"step": self.opt_state["step"],
                                  "slots": slots}}}

    # -- the integrity check ------------------------------------------------
    def _integrity_trees(self):
        """The parts a check step fingerprints, in the reference's order."""
        st = self.state
        return (("params", st["params"]), ("opt", self.opt_state),
                ("comm_err", self.comm_err))

    def _init_integrity(self):
        """Entry names and split axes of the check, the reference's order:
        each part's leaves in sorted-key order. A leaf split over live
        check axes (a residual row, a ZeRO slice) gets the combined digest
        over them and no vote; every other leaf is compared."""
        self.integrity_axes = self.mesh.live(self.reduce_axes)
        self.replica_rank = self.mesh.rank_in(self.integrity_axes)
        layout = self._layout()
        entries = []
        for part, tree in self._integrity_trees():
            for path, _ in _leaves_with_path(tree):
                dotted = ".".join((part,) + tuple(map(str, path)))
                pc = layout.get(dotted)
                # a residual row differs over every check axis; a ZeRO
                # slice over sharding; a model/pipe slice is compared with
                # the ranks that hold the same slice
                axes = (() if pc is None else self.integrity_axes if pc.row
                        else self.mesh.live("sharding")
                        if "sharding" in self._piece_axes.get(dotted, ())
                        else ())
                entries.append((part + _keystr(path), axes))
        self._integrity_entries = entries
        self._integrity_cmp_idx = [i for i, (_, a) in enumerate(entries)
                                   if not a]
        by_axes = OrderedDict()
        for i, (_, a) in enumerate(entries):
            if a:
                by_axes.setdefault(a, []).append(i)
        self._integrity_rank_idx = by_axes

    def _integrity_check(self):
        """Fingerprint the state, compare across the check ranks, record."""
        leaves = [v for _, tree in self._integrity_trees()
                  for _, v in _leaves_with_path(tree)]
        fps = (torch.stack([fingerprint_array(v) for v in leaves]) if leaves
               else torch.zeros(0, dtype=torch.int64, device=self.device))
        for axes, idx in self._integrity_rank_idx.items():
            idx = torch.tensor(idx, device=fps.device)
            comb = fps[idx]
            dist.all_reduce(comb, op=dist.ReduceOp.SUM,
                            group=self.mesh.group_of(axes))
            fps[idx] = comb & 0xFFFFFFFF
        cmp_idx = self._integrity_cmp_idx
        group = (self.mesh.group_of(self.integrity_axes)
                 if self.integrity_axes else None)
        if group is not None and cmp_idx:
            idx = torch.tensor(cmp_idx, device=fps.device)
            lo, hi = fps[idx], fps[idx]
            # the tag marks the two fingerprint collectives in a traced
            # step (integrity.count_fingerprint_collectives)
            with (_fx_traceback.annotate(FINGERPRINT_TAG) if self._tracing
                  else contextlib.nullcontext()):
                dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
                dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
            div = lo != hi
        else:
            div = torch.zeros(len(cmp_idx), dtype=torch.bool,
                              device=fps.device)
        if self._flag_axes and cmp_idx:
            # one verdict on every rank, whichever slice diverged
            d = div.to(torch.int32)
            dist.all_reduce(d, op=dist.ReduceOp.MAX,
                            group=self.mesh.group_of(self._flag_axes))
            div = d > 0
        if self._tracing:
            return      # the host read of the verdict is no node of a graph
        self._record_integrity(fps, div)

    def _record_integrity(self, fps, div):
        """The host side of a check step: read the divergence mask (one
        sync) and remember which compared leaves differed."""
        self.last_fingerprints = fps
        mask = div.tolist()
        diverged = [self._integrity_entries[i][0]
                    for i, m in zip(self._integrity_cmp_idx, mask) if m]
        self.last_divergence = diverged
        if _telemetry.enabled():
            _telemetry.counter(
                "integrity_check_steps_total",
                "train steps that ran the fingerprint check program").inc()
            if diverged:
                c = _telemetry.counter(
                    "replica_divergence_total",
                    "integrity checks where a leaf's fingerprint differed "
                    "across data-parallel ranks")
                for n in diverged:
                    c.inc(leaf=n)
        return diverged

    def consume_divergence(self) -> list:
        """Diverged leaf names of the latest check step, cleared on read
        (``run_resilient`` polls it after every step)."""
        out, self.last_divergence = self.last_divergence, []
        return out

    def remesh(self, mesh):
        """Move onto ``mesh`` (module docstring): its process group must be
        of this trainer's device's backend. The optimizer state, residuals,
        NaN guard and loss scale start fresh; the parameters keep their
        values (stage 3: from the model, so :meth:`sync_to_model` first)."""
        from .mesh import set_mesh
        self._check_mesh(mesh)
        self.mesh = mesh
        set_mesh(mesh)
        self._setup()
        return self

    # -- the exchange plan --------------------------------------------------
    def _init_exchange(self):
        mesh = self.mesh
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
        # the sharding hop of the ZeRO-2 leaves: quantized when that axis's
        # policy is (ZeRO-3 leaves always reduce-scatter losslessly)
        rs = (self._axis_policy.get("sharding", "fp32")
              if isinstance(self._axis_policy, dict) else self._axis_policy)
        self._rs_policy = rs if rs in QUANTIZED_POLICIES else None
        plain_keys = [k for k in self.params if k not in self.zero2_dims
                      and k not in self.zero3_dims]
        self._plain = frozenset(plain_keys)
        # per-rank error-feedback residuals, full-tensor shaped: this rank's
        # row of the reference's replica-major comm_err
        res_keys = []
        if quantized:
            res_keys = [k for k in self.params if k in self._plain or (
                k in self.zero2_dims and self._rs_policy is not None)]
        self.comm_err = OrderedDict(
            (k, torch.zeros(self._full_shape(k), dtype=torch.float32,
                            device=self.device)) for k in res_keys)
        # fp32/bf16: one-rank axes are no-ops and are skipped; the
        # quantized policies keep them, so the round trip runs at any size
        self.sync_axes = tuple(ax for ax in self.reduce_axes
                               if quantized or mesh.shape[ax] > 1)
        use_buckets = (self.grad_sync_buckets > 1 and bool(self.sync_axes)
                       and len(plain_keys) >= 2 and self.pp is None)
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
        # telemetry: logical wire bytes per rank of one step's bucketed
        # exchange, per (policy, link, bucket)
        n_sync = mesh.axes_size(self.sync_axes) if self.sync_axes else 1
        self._wire_parts = []
        self._wire_bytes_per_step = 0.0
        self._wire_fp32_per_step = 0.0
        if plain_keys and n_sync > 1:
            k = self.accumulate_steps
            links = axis_links(mesh)
            params = {n: self.params[n].detach() for n in plain_keys}
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

    def _data_mean(self, g):
        """The mean over the ``data`` group, then over ``sep`` (bf16 on
        the wire under ``fp16_allreduce``, as the reference's ``_pmean``
        over each)."""
        for ax in ("data", "sep"):
            n = self.mesh.shape[ax]
            if n == 1:
                continue
            wire = (g.to(torch.bfloat16) if self.fp16_allreduce
                    and g.dtype == torch.float32 else g.clone())
            dist.all_reduce(wire, group=self.mesh.group_of(ax))
            g = div_const(wire, n).to(g.dtype)
        return g

    def _zero_exchange(self, grads: dict):
        """The ZeRO leaves' reduce-scatters (reference ``engine.py:
        735-800``): this rank's slice of each mean gradient, and the new
        residuals of a quantized sharding hop."""
        grads = self._unscale(grads)
        out, res = {}, {}
        for k in sorted(grads):
            g = grads[k]
            if k in self.zero3_dims:
                g = psum_scatter(g, "sharding", self.zero3_dims[k],
                                 mesh=self.mesh)
            elif self._rs_policy is not None:
                r = self.comm_err.get(k)
                g = compressed_psum_scatter(
                    g, "sharding", self.zero2_dims[k],
                    policy=self._rs_policy, block=self.grad_sync_block,
                    residual=r, mesh=self.mesh)
                if r is not None:
                    g, res[k] = g
            else:
                g = psum_scatter(g, "sharding", self.zero2_dims[k],
                                 mesh=self.mesh)
            out[k] = self._data_mean(div_const(g, self.n_shard))
        return out, res

    # -- run ----------------------------------------------------------------
    def train_step(self, inputs, labels, lr: Optional[float] = None,
                   grad_taint: Optional[float] = None) -> torch.Tensor:
        """One step; returns the 0-d loss (the mean over every data rank)
        on the device (no host sync unless telemetry is on). Issued under
        the trainer's state lock."""
        with self._state_lock:
            return self._train_step(inputs, labels, lr, grad_taint)

    def _train_step(self, inputs, labels, lr, grad_taint):
        lr = self.optimizer.get_lr() if lr is None else lr
        k = self.accumulate_steps
        self._steps_run += 1
        ce = self.integrity_check_every
        tracing = self._tracing
        tel = _telemetry.enabled() and not tracing
        t0 = time.perf_counter() if tel else 0.0
        # the host range of the profiler's trace, only while it is on
        ev = (_profiler.RecordEvent("train_step").begin()
              if _profiler.is_profiler_enabled() and not tracing else None)
        inputs = _to_device(inputs, self.device)
        labels = _to_device(labels, self.device)
        lead = _lead(inputs)
        if k > 1 and lead is not None and lead.dim() and lead.shape[0] % k:
            raise ValueError(f"batch size {lead.shape[0]} is not divisible "
                             f"by accumulate_steps={k}")
        names = list(self.params)
        comm_err0 = self.comm_err
        stats0 = [(m, b, getattr(m, b)) for m, b in self._stat_owners]
        self._gather_params()
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
        self._update(grads, lr, comm_err0, stats0)
        self._free_params()
        if ce and self._steps_run % ce == 0:
            self._integrity_check()
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

    @torch.no_grad()
    def _update(self, grads, lr, comm_err0, stats0=()):
        """The optimizer on each leaf's update view (a ZeRO slice or the
        whole parameter), the NaN guard, and the new values written back:
        stage-3 slices stay, other slices are all-gathered over
        ``sharding``. ``stats0``: (module, name, tensor) of each statistic
        buffer before the forward, put back on a skipped step."""
        ud = self._update_dims
        old = OrderedDict((k, self._update_view(k)) for k in self.params)
        upd = {}
        for k, g in grads.items():
            if g is not None and k in ud and k in self._plain:
                g = self._slice(g, ud[k])      # stage 1: the full mean
            upd[k] = g
        sliced = any(k in ud for k, g in upd.items() if g is not None)
        split = {k: grp for k, grp in self._split_groups.items()
                 if upd.get(k) is not None} or None
        new_params, new_opt = self._opt.apply_gradients(
            old, upd, self.opt_state, lr=lr, split=split)
        self._mean_batch_stats(stats0)
        if self.nan_guard or self.amp is not None:
            finite = all_finite(g for g in upd.values() if g is not None)
            flag_axes = self.mesh.live(
                self._flag_axes + (("sharding",) if sliced else ()))
            if flag_axes:
                flag = finite.to(torch.int32).reshape(1)
                dist.all_reduce(flag, op=dist.ReduceOp.MIN,
                                group=self.mesh.group_of(flag_axes))
                finite = flag[0] > 0
            if self.nan_guard:
                new_params = {n: torch.where(finite, v, old[n])
                              for n, v in new_params.items()}
                new_opt = _keep(finite, new_opt, self.opt_state)
                self.comm_err = _keep(finite, self.comm_err, comm_err0)
                for m, b, old_b in stats0:
                    new_b = getattr(m, b)
                    if new_b is not old_b:
                        setattr(m, b, torch.where(finite, new_b, old_b))
                self.skipped += (~finite).to(torch.int32)
            if self.amp is not None:
                self.amp = self.scaler.update_scale_state(self.amp, ~finite)
        for n, p in self.params.items():
            v = new_params[n]
            if n in self._shards:
                self._shards[n].copy_(v)
            elif n in ud:
                p.copy_(all_gather_dim(v.contiguous(), "sharding", ud[n],
                                       mesh=self.mesh))
            else:
                p.copy_(v)
        self.opt_state = new_opt

    def _mean_batch_stats(self, stats0):
        """The batch statistics this step's forward replaced, averaged over
        the live batch axes each does not already agree over (one float32
        all-reduce a set of axes)."""
        by_axes = {}
        for m, b, old_b in stats0:
            synced = getattr(m, "_stat_sync_axes", None)
            new_b = getattr(m, b)
            if synced is None or new_b is old_b:
                continue
            axes = self.mesh.live(tuple(ax for ax in self.reduce_axes
                                        if ax not in synced))
            if axes:
                by_axes.setdefault(axes, []).append((m, b, new_b))
        for axes, owned in by_axes.items():
            flat = torch.cat([v.reshape(-1).float() for _, _, v in owned])
            dist.all_reduce(flat, group=self.mesh.group_of(axes))
            flat = div_const(flat, self.mesh.axes_size(axes))
            parts = flat.split([v.numel() for _, _, v in owned])
            for (m, b, v), part in zip(owned, parts):
                setattr(m, b, part.reshape(v.shape).to(v.dtype))

    def _grads(self, names, inputs, labels):
        """(loss, exchanged grads in ``names`` order) of one forward and
        backward on this rank's slice of the batch; updates the residuals.
        A ZeRO-2/3 leaf's gradient is this rank's slice."""
        inputs, labels = (
            _shard(_shard(x, self.n_batch, self.batch_rank), self.n_sep,
                   self.mesh.coord["sep"], dim=1, min_rank=2)
            for x in (inputs, labels))
        scale = self.amp["scale"] if self.amp is not None else None
        hooks = None
        if self.pp is not None:
            loss, grads = self.pp.train_batch(
                inputs, labels, self.loss_fn,
                OrderedDict((n, self.params[n]) for n in names),
                micro_batches=self.micro_batches, scale=scale)
        else:
            if self.remat:
                out = checkpoint(_RngReplay(self.model, self.device), inputs,
                                 use_reentrant=False)
            else:
                out = self.model(inputs)
            loss = self.loss_fn(out, labels)
            target = loss if scale is None else loss * scale.to(loss.dtype)
            hooks = (_BucketHooks(self, names) if self._use_buckets
                     and torch.is_grad_enabled() else None)
            try:
                raw = torch.autograd.grad(
                    target, [self.params[n] for n in names],
                    allow_unused=True)
            except BaseException:
                if hooks is not None:
                    for h in hooks.handles:
                        h.remove()
                raise
            grads = dict(zip(names, raw))
        live = {n: g for n, g in grads.items()
                if g is not None and n in self._plain}
        if hooks is not None:
            means, res = hooks.finish(live)
        elif self.sync_axes and live:
            means, res = self._start_exchange(live)()
        else:
            means, res = self._unscale(live), {}
        means, res = dict(means), dict(res or {})
        zero = {n: g for n, g in grads.items()
                if g is not None and n not in self._plain}
        if zero:
            zmeans, zres = self._zero_exchange(zero)
            means.update(zmeans)
            res.update(zres)
        grads.update(means)
        if res:
            self.comm_err = OrderedDict(self.comm_err)
            self.comm_err.update(res)
        loss = loss.detach()
        for ax in self.reduce_axes:   # the reference's pmean over each axis
            n = self.mesh.shape[ax]
            if n > 1:
                loss = loss.clone()
                dist.all_reduce(loss, group=self.mesh.group_of(ax))
                loss = div_const(loss, n)
        if scale is not None and self.pp is None:
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
        ov = (self._step_cost or {}).get("overlap") or {}
        if ov.get("overlap_efficiency") is not None:
            _telemetry.gauge(
                "grad_sync_overlap_efficiency",
                "fraction of the traced step's collective time the "
                "overlap model predicts is hidden under compute").set(
                    ov["overlap_efficiency"])
        if ov.get("makespan") and dt > 0:
            # the overlap model's step against this step's wall clock
            from ..telemetry import calibration
            calibration.record("step_time", ov["makespan"], dt,
                               step=self._steps_run)
        if self.comm_err:
            _telemetry.gauge(
                "grad_sync_residual_norm",
                "L2 norm of the error-feedback residual").set(
                    residual_norm(dict(self.comm_err)))

    # -- staging / analysis -------------------------------------------------
    # the trainer's state a step reads or replaces, after the model's own
    # tensors (``_staging.state_leaves``' order)
    _STATE_ATTRS = ("opt_state", "comm_err", "skipped", "amp", "_shards")
    _KEEP_ATTRS = ("_steps_run", "integrity_check_every",
                   "last_fingerprints", "last_divergence", "_tracing")

    def _staged(self, inputs, labels, lr=None, do_check=False):
        """``(graph, donated)``: ``train_step`` traced on fakes of the state
        (``distributed/_staging.py``), as a check step or not, and the
        graph inputs that hold the state it replaces (parameters,
        optimizer state, residuals, guard, stage-3 slices; not buffers)."""
        from ..analysis.walker import trace_program
        from ._staging import bound, state_leaves, tree_leaves
        lr = self.optimizer.get_lr() if lr is None else lr
        leaves, n_model = state_leaves(self.model, self, self._STATE_ATTRS)

        def step(state, ins, lbs):
            with bound(self.model, self, self._STATE_ATTRS, state,
                       self._KEEP_ATTRS):
                every = self.integrity_check_every
                if do_check:
                    self.integrity_check_every = every or 1
                    self._steps_run = self.integrity_check_every - 1
                else:
                    self.integrity_check_every = 0
                self._tracing = True
                loss = self.train_step(ins, lbs, lr)
                new = (tree_leaves(self.opt_state) +
                       tree_leaves(self.comm_err) + [self.skipped] +
                       tree_leaves(self.amp) +
                       [getattr(m, b) for m, b in self._stat_owners])
            return loss, new

        graph = trace_program(step, leaves, _to_device(inputs, self.device),
                              _to_device(labels, self.device))
        n_params = sum(1 for t in leaves[:n_model]
                       if isinstance(t, torch.nn.Parameter))
        donated = set(range(n_params)) | set(range(n_model, len(leaves)))
        return graph, donated

    def staged_graph(self, inputs, labels, lr=None, do_check=False):
        """The traced step for this batch (nothing allocated on the card,
        nothing launched; the trainer left bit for bit as it was): one
        ``train_step``'s ATen ops, kernel ops and collectives as a
        ``torch.fx.GraphModule`` (``analysis/walker.py``). Its inputs are
        the state (``_staging.state_leaves``' order), then the inputs and
        labels. ``do_check=True`` traces the integrity-check step. The
        reference's ``staged_jaxpr`` (``engine.py:1227``)."""
        return self._staged(inputs, labels, lr, do_check)[0]

    def staged_in_specs(self, inputs, labels):
        """One layout a graph input of :meth:`staged_graph`, in order: a
        tuple of axis tuples a dim (``analysis.sharding`` reads it) from
        the trainer's own plan — a parameter's ``pspec`` (its
        tensor-parallel or pipeline split), a ZeRO slice's ``sharding``
        dim, a residual row's reduce axes on a leading dim that this rank's
        row drops — and whole (no axes) for everything else."""
        from ._staging import state_leaves, tree_leaves
        leaves, n_model = state_leaves(self.model, self, ())
        names = {}
        for k, p in self.params.items():
            names.setdefault(id(p), k)
        specs = []
        for t in leaves:
            k = names.get(id(t))
            own = dict(self.own_splits.get(k, ())) if k else {}
            dims = [()] * t.dim()
            for ax, d in own.items():
                if d < len(dims):
                    dims[d] = (ax,)
            specs.append(tuple(dims))
        slot_of = {}
        for k, d in self.opt_state["slots"].items():
            for s_, v in d.items():
                slot_of[id(v)] = (k, s_)
        for name in self._STATE_ATTRS:
            for t in tree_leaves(getattr(self, name)):
                dims = [()] * t.dim()
                if name == "opt_state" and id(t) in slot_of:
                    k, s_ = slot_of[id(t)]
                    d = self.slot_dims.get(k, {}).get(s_)
                    if d is not None and k in self._update_dims:
                        dims[d] = ("sharding",)
                specs.append(tuple(dims))
        return specs + [None] * (len(_flat_list(inputs)) +
                                 len(_flat_list(labels)))

    def compile(self, inputs, labels, lr: Optional[float] = None,
                analyze: bool = False, config=None):
        """The step for this batch shape, traced and priced without
        running it (reference ``engine.py:1117``): returns the step
        callable (``lambda: self.train_step(inputs, labels, lr)``); with
        ``analyze=True`` also the :class:`~..analysis.Report` of the
        traced step (findings, cost, the overlap model over the mesh; the
        graph itself as ``report.graph``).
        The trace prices the step for the telemetry of the steps that
        follow (``grad_sync_overlap_efficiency``, the ``step_time``
        calibration pair)."""
        import dataclasses
        t0 = time.perf_counter()
        graph, donated = self._staged(inputs, labels, lr)
        self._step_cost = self._trace_step_cost(graph)
        if _telemetry.enabled():
            _telemetry.histogram(
                "compile_time_seconds",
                "ParallelTrainer.compile wall time").observe(
                    time.perf_counter() - t0)

        def step():
            return self.train_step(inputs, labels, lr)

        if not analyze:
            return step
        from .. import analysis
        cfg = config or analysis.AnalysisConfig()
        if cfg.grad_sync_buckets == 0:
            cfg = dataclasses.replace(
                cfg, grad_sync_buckets=(len(self.grad_sync_bucket_keys)
                                        if self._use_buckets else 1))
        report = analysis.analyze_graph(
            graph, mesh=self.mesh, donated=donated, config=cfg,
            in_specs=self.staged_in_specs(inputs, labels))
        report.graph = graph        # the traced step the report reads
        return step, report

    def _trace_step_cost(self, graph):
        """The traced step's FLOPs, peak live bytes and overlap model, for
        telemetry; never raises into training."""
        try:
            from ..analysis import cost as _cost
            out = {"flops": _cost.total_flops(graph),
                   "peak_live_bytes": _cost.peak_live_bytes(graph)}
            out["overlap"] = _cost.overlap_summary(graph, self.mesh)
            return out
        except Exception:
            return None

    def program_family(self, inputs, labels, lr=None):
        """The plain and the integrity-check step as a declared
        :class:`~..analysis.schedule.ProgramFamily`: ``train_step`` picks
        between them with ``_steps_run % integrity_check_every``, a host
        counter every rank keeps alike (rank-invariant)."""
        from ..analysis.schedule import ProgramFamily
        return ProgramFamily(
            name="trainer-step",
            selector="steps_run % integrity_check_every "
                     "(host-replicated step counter)",
            rank_invariant=True,
            members={
                "step": lambda: self.staged_graph(inputs, labels, lr),
                "step-check": lambda: self.staged_graph(
                    inputs, labels, lr, do_check=True)},
            mesh=self.mesh)

    # -- state and checkpoints ----------------------------------------------
    @property
    def opt_state(self):
        """The optimizer state (``step`` and ``slots``), kept on the
        optimizer so that ``optimizer.state_dict()`` holds it."""
        return self._opt.state

    @opt_state.setter
    def opt_state(self, value):
        self._opt.state = value

    @property
    def state(self) -> ShardedState:
        """The trainer's whole state over this rank's live tensors, the
        reference's ``ParallelTrainer.state``: ``params`` (every model
        parameter, each once; a stage-3 leaf as this rank's slice),
        ``buffers`` (the persistent ones), ``opt``, ``comm_err`` (this
        rank's residual rows) and ``guard`` (``skipped``, and ``amp`` with
        a scaler), with the ``layout`` of each split leaf. Assigning a
        state of the same structure copies it into the live tensors in
        place; a dtype or shape that differs raises."""
        params = OrderedDict(self.model.named_parameters())
        seen = {id(p) for p in params.values()}
        params.update(self._shards)
        buffers = OrderedDict(
            (k, v) for k, v in self.model.state_dict(keep_vars=True).items()
            if id(v) not in seen)
        guard = {"skipped": self.skipped}
        if self.amp is not None:
            guard["amp"] = self.amp
        out = ShardedState(params=params, buffers=buffers,
                           opt=self.opt_state, comm_err=self.comm_err,
                           guard=guard)
        out.layout = self._layout()
        out.world = self.mesh
        return out

    @state.setter
    def state(self, value: dict):
        _copy_state(self.state, value, "state")

    def _layout(self) -> dict:
        """Dotted path -> :class:`Piece` for every leaf that is not
        replicated on the whole mesh: ZeRO slices, tensor-parallel slices
        and stage members (and their slots), and residual rows
        (``(n_reduce, *shape)``, data-major, with the leaf's own split on
        the trailing dims). Each piece is written by the one rank of its
        set of equal copies whose coordinates off the piece's axes are 0;
        ``self._piece_axes`` keeps each piece's axes."""
        mesh = self.mesh
        live = mesh.live(AXES_ORDER)
        out, self._piece_axes = {}, {}

        def piece(path, shape, splits, row=False):
            axes = {a for ax, _, _, _ in splits
                    for a in (ax if isinstance(ax, tuple) else (ax,))}
            write = all(mesh.coord[a] == 0 for a in live if a not in axes)
            (_, d, i, c), extra = splits[0], splits[1:]
            out[path] = Piece(tuple(shape), d, i, c, row, write,
                              tuple((dd, ii, cc) for _, dd, ii, cc in extra))
            self._piece_axes[path] = axes

        def own(k, shift=0):
            return [(ax, d + shift, mesh.coord[ax], mesh.shape[ax])
                    for ax, d in self.own_splits[k]]

        zero = ("sharding",)
        for k in self.params:
            splits = own(k)
            if k in self.zero3_dims:
                splits = [(zero, self.zero3_dims[k], self.shard_rank,
                           self.n_shard)] + splits
            if splits:
                piece("params." + k, self._logical_shape(k), splits)
        for k, dims in self.slot_dims.items():
            local = tuple(self.params[k].shape)
            for s, v in self.opt_state["slots"].get(k, {}).items():
                d = dims.get(s)
                if d is not None and k in self._update_dims:
                    piece(f"opt.slots.{k}.{s}", self._full_shape(k),
                          [(zero, d, self.shard_rank, self.n_shard)])
                elif own(k) and tuple(v.shape) == local:
                    piece(f"opt.slots.{k}.{s}", self._logical_shape(k),
                          own(k))
        for k in self.comm_err:
            piece("comm_err." + k, (self.n_reduce,) + self._logical_shape(k),
                  [(self.reduce_axes, 0, self.reduce_rank, self.n_reduce)]
                  + own(k, shift=1), row=True)
        return out

    def save_checkpoint(self, path: str, use_async: bool = False):
        """Save :attr:`state` as a checkpoint directory
        (``distributed/checkpoint.py``); returns the directory, or with
        ``use_async`` an ``AsyncSave`` once the host copy is taken (its
        ``wait_until_finished()`` returns the directory). Over 2+ ranks it
        is the one directory of the world: every rank calls this with the
        same ``path``."""
        from .checkpoint import save_checkpoint as _save
        return _save(path, self.state, use_async=use_async)

    def load_checkpoint(self, path: str):
        """Restore :attr:`state` from a checkpoint directory, in place, on
        this trainer's device (either format; a world's directory onto any
        ``data`` x ``sharding`` layout)."""
        from .checkpoint import load_checkpoint as _load
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
        """The parameter's stored values (a stage-3 leaf: this rank's
        slice)."""
        if name in self._shards:
            return self._shards[name]
        return self.params[name].detach()

    def set_param(self, name, value):
        """Replace a parameter's values (the whole parameter; a stage-3
        leaf keeps this rank's slice of it)."""
        with torch.no_grad():
            value = torch.as_tensor(value)
            if name in self._shards:
                dst = self._shards[name]
                value = self._slice(value, self.zero3_dims[name])
            else:
                dst = self.params[name]
            dst.copy_(value.to(dst.dtype))

    def get_opt_slot(self, name, slot) -> Optional[torch.Tensor]:
        return self.opt_state["slots"].get(name, {}).get(slot)

    # -- live-state access (the heter hot tier between steps) -----------------
    def param_name_of(self, param) -> Optional[str]:
        """The model's name for ``param`` (by identity), or None."""
        for n, p in self.model.named_parameters():
            if p is param:
                return n
        return None

    def opt_slot_names(self, name) -> list:
        """Names of the optimizer's tensor slots kept for a parameter."""
        d = self.opt_state["slots"].get(name, {})
        return [k for k, v in d.items() if isinstance(v, torch.Tensor)]

    def set_opt_slot(self, name, slot, value):
        """Copy ``value`` into a parameter's optimizer slot, in place."""
        with torch.no_grad():
            dst = self.opt_state["slots"][name][slot]
            dst.copy_(torch.as_tensor(value).to(dst.device, dst.dtype))


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


def _flat_list(x) -> list:
    """The array leaves of an input: a tensor or array, or a tuple/list."""
    if isinstance(x, (tuple, list)):
        return [v for e in x for v in _flat_list(e)]
    return [x] if isinstance(x, (torch.Tensor, np.ndarray)) else []


def _keep(finite, new, old):
    """torch.where(finite, new, old) over a nested dict of tensors."""
    if isinstance(new, dict):
        return type(new)((k, _keep(finite, v, old[k])) for k, v in new.items())
    return torch.where(finite, new, old)
