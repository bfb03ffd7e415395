"""``ShardingParallel`` (ZeRO) and the sharding rule of its leaves.

Port of ``paddle_tpu/distributed/meta_parallel/sharding_parallel.py``. The
reference shards the optimizer state (stage 1), the gradients (stage 2)
and the parameters (stage 3) over the ``sharding`` mesh axis with
``PartitionSpec``s that GSPMD partitions; the port's trainer
(``distributed/engine.py``) does the same slicing by hand, one process a
card. A spec here is a tuple with one entry a dimension, the axis name
that dimension is split over or None (``()`` is replicated): the
reference's ``PartitionSpec`` as plain data.

:func:`shard_spec_for` is the reference's choice exactly: a leaf under
``min_size`` elements stays replicated; otherwise its largest dimension
divisible by ``n_shards`` is split, taking the dims in the order
``np.argsort(dims)[::-1]`` (numpy's default sort, so a square weight
splits where numpy's order puts it first, as in the reference).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ...nn.layer import Layer

__all__ = ["SHARDING_AXIS", "shard_spec_for", "spec_dim",
           "opt_state_shardings", "ShardingParallel"]

SHARDING_AXIS = "sharding"


def _shape_of(value) -> Tuple[int, ...]:
    return tuple(int(d) for d in getattr(value, "shape", value))


def shard_spec_for(value, axis=SHARDING_AXIS, n_shards=1, min_size=1024):
    """The spec splitting ``value``'s largest divisible dim over ``axis``,
    or ``()`` (replicated) when ``value`` is too small, ``n_shards`` is 1
    or no dim divides. ``value`` is a tensor, an array or a shape."""
    dims = list(_shape_of(value))
    size = int(np.prod(dims)) if dims else 1
    if n_shards <= 1 or size < min_size:
        return ()
    order = np.argsort(dims)[::-1]
    for d in order:
        if dims[d] % n_shards == 0:
            spec = [None] * len(dims)
            spec[d] = axis
            return tuple(spec)
    return ()


def spec_dim(spec, axis=SHARDING_AXIS) -> Optional[int]:
    """The dim of ``spec`` split over ``axis`` (None: not split on it)."""
    for d, ax in enumerate(spec or ()):
        if ax == axis or (isinstance(ax, tuple) and axis in ax):
            return d
    return None


def opt_state_shardings(opt_state, n_shards, axis=SHARDING_AXIS):
    """An optimizer state tree mapped to ZeRO-1 specs (each leaf as
    :func:`shard_spec_for` splits it)."""
    if isinstance(opt_state, dict):
        return type(opt_state)((k, opt_state_shardings(v, n_shards, axis))
                               for k, v in opt_state.items())
    return shard_spec_for(opt_state, axis, n_shards)


class ShardingParallel(Layer):
    """Wraps a model for ZeRO sharding. ``strategy.sharding_configs``
    gives ``stage`` and the gradient-exchange settings the trainer reads:
    ``grad_sync`` ("fp32" | "bf16" | "int8" | "int4"), ``grad_sync_block``
    (None: the policy's default), ``grad_sync_dcn_only`` and
    ``grad_sync_bucket_bytes``. At stage 3 every parameter without a spec
    gets :func:`shard_spec_for`'s as its ``pspec``, which the trainer
    honours whatever its ``zero_stage``, as the reference's does."""

    def __init__(self, layers, hcg, strategy=None):
        super().__init__()
        self._layers = layers
        self._hcg = hcg
        self.stage = 1
        self.grad_sync = "fp32"
        self.grad_sync_block = None
        self.grad_sync_bucket_bytes = 4 << 20
        self.grad_sync_dcn_only = False
        if strategy is not None:
            cfg = strategy.sharding_configs
            self.stage = int(cfg.get("stage", 1))
            self.grad_sync = cfg.get("grad_sync", "fp32")
            blk = cfg.get("grad_sync_block", None)
            self.grad_sync_block = int(blk) if blk is not None else None
            self.grad_sync_bucket_bytes = int(
                cfg.get("grad_sync_bucket_bytes", 4 << 20))
            self.grad_sync_dcn_only = bool(
                cfg.get("grad_sync_dcn_only", False))
        n = hcg.get_sharding_parallel_world_size()
        if self.stage >= 3:
            for p in layers.parameters():
                if getattr(p, "pspec", None) is None:
                    p.pspec = shard_spec_for(p, SHARDING_AXIS, n)

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def load_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)

    set_state_dict = load_state_dict

    def named_parameters(self, prefix="", recurse=True,
                         remove_duplicate=True):
        return self._layers.named_parameters(prefix, recurse,
                                             remove_duplicate)
