"""``paddle_tpu_torch.distributed.sharding``: the grouped ZeRO API.

Port of ``paddle_tpu/distributed/sharding/__init__.py``. The levels map to
ZeRO stages on the ``sharding`` mesh axis, which
``distributed/engine.py``'s trainer carries out:

- ``"os"``: the optimizer state (stage 1);
- ``"os_g"``: and the gradients, through a reduce-scatter (stage 2);
- ``"p_g_os"``: and the parameters (stage 3).

:func:`group_sharded_parallel` records the stage on the model and the
optimizer; :func:`build_trainer` builds a ``ParallelTrainer`` at it.
:func:`zero_bytes_per_rank` counts what one rank holds at each stage (``python
-m paddle_tpu_torch.distributed.sharding`` prints the table for GPT-base and
gpt_1p3b: computed from the leaves' shapes, not measured).
"""
from __future__ import annotations

import os

__all__ = ["group_sharded_parallel", "get_group_sharded_stage",
           "save_group_sharded_model", "build_trainer",
           "zero_bytes_per_rank"]

_LEVELS = {"os": 1, "os_g": 2, "p_g_os": 3}


def group_sharded_parallel(model, optimizer, level: str,
                           scaler=None, group=None, offload: bool = False,
                           sync_buffers: bool = False, buffer_max_size=None,
                           segment_size=None, sync_comm: bool = False):
    """Record the ZeRO stage of ``level`` on ``model`` and ``optimizer``
    -> ``(model, optimizer, scaler)``, as the reference. The partitioning
    itself happens in a ``ParallelTrainer`` on a mesh with a ``sharding``
    axis. ``offload=True`` (host-offloaded optimizer state) raises, as in
    the reference."""
    if level not in _LEVELS:
        raise ValueError(
            f"level must be one of {sorted(_LEVELS)}, got {level!r}")
    if offload:
        raise NotImplementedError(
            "offload=True (host-offloaded optimizer state) is not wired; "
            "ZeRO stages shard state across devices instead")
    stage = _LEVELS[level]
    model._group_sharded_stage = stage
    optimizer._group_sharded_stage = stage
    return model, optimizer, scaler


def get_group_sharded_stage(model_or_opt) -> int:
    return getattr(model_or_opt, "_group_sharded_stage", 0)


def save_group_sharded_model(model, output: str, optimizer=None):
    """Write the consolidated model (and optimizer) state to the checkpoint
    directory ``output``: ``{"model": state_dict, "opt": optimizer
    state}``, as the reference. Under a ZeRO trainer the slices are
    gathered first (a collective: every rank calls this) and the mesh's
    rank 0 writes."""
    from ..checkpoint import save_checkpoint
    ref = getattr(model, "_zero_trainer", None) or \
        getattr(getattr(optimizer, "_inner_opt", optimizer), "_zero_trainer",
                None)
    trainer = ref() if ref is not None else None
    if trainer is not None:
        state = trainer.consolidated_state()
        if optimizer is None:
            state.pop("opt")
        if trainer.mesh.rank != 0:
            return output
    else:
        state = {"model": model.state_dict()}
        if optimizer is not None and hasattr(optimizer, "state_dict"):
            state["opt"] = optimizer.state_dict()
    save_checkpoint(os.path.abspath(output), state)
    return output


def build_trainer(model, optimizer, loss_fn, **kwargs):
    """A ``ParallelTrainer`` at the stage :func:`group_sharded_parallel`
    recorded (an explicit ``zero_stage`` wins)."""
    from ..engine import ParallelTrainer
    stage = get_group_sharded_stage(model) or get_group_sharded_stage(
        optimizer)
    kwargs.setdefault("zero_stage", stage)
    return ParallelTrainer(model, optimizer, loss_fn, **kwargs)


def zero_bytes_per_rank(model, optimizer, stage: int, n_shards: int) -> dict:
    """Bytes one rank holds between steps at ZeRO ``stage`` over
    ``n_shards`` sharding ranks, split as the trainer splits
    (``shard_spec_for``): ``params`` (stage 3: the slices), ``grads`` (a
    step's gradients, in the parameters' dtype; stages 2-3: the slices)
    and ``slots`` (``optimizer.init_slots`` of each parameter; stages 1-3:
    the slices). The model may live on the meta device. Stage 3's
    all-gathered parameters, alive during a step, are not counted."""
    import torch
    from ..meta_parallel.sharding_parallel import shard_spec_for, spec_dim
    out = {"params": 0, "grads": 0, "slots": 0}
    for _, p in model.named_parameters():
        split = (n_shards > 1 and stage >= 1 and
                 spec_dim(shard_spec_for(p, n_shards=n_shards)) is not None)

        def share(nbytes, from_stage):
            return nbytes // n_shards if split and stage >= from_stage \
                else nbytes
        pbytes = p.numel() * p.element_size()
        out["params"] += share(pbytes, 3)
        out["grads"] += share(pbytes, 2)
        meta = torch.empty(p.shape, dtype=p.dtype, device="meta")
        for v in optimizer.init_slots(meta).values():
            out["slots"] += share(v.numel() * v.element_size(), 1)
    return out
