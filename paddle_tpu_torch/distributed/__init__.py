"""paddle_tpu_torch.distributed — data and ZeRO parallelism over
``torch.distributed``: the environment (``env``), the mesh of five axes
and its topology (``mesh``), the collectives (``collective``), the
compressed gradient exchange (``compressed``), ``DataParallel``, ``spawn``,
the fleet API (``fleet``), the hybrid wrappers (``meta_parallel``:
``ShardingParallel``, ``HybridParallelOptimizer``), the grouped ZeRO API
(``sharding``), ``engine.ParallelTrainer`` (ZeRO stages 1-3 on a
``data`` x ``sharding`` mesh) and ``checkpoint`` (the trainer's state on
disk, one directory for a world of ranks)."""
from .collective import (ReduceOp, all_gather, all_reduce,  # noqa: F401
                         alltoall, barrier, broadcast, get_group, new_group,
                         recv, reduce, reduce_scatter, scatter, send, split,
                         split_group, wait)
from .env import (ParallelEnv, get_rank, get_world_size,  # noqa: F401
                  init_parallel_env)
from .parallel import DataParallel, sync_params_buffers  # noqa: F401
from .spawn import spawn  # noqa: F401
from . import checkpoint, fleet, meta_parallel, sharding  # noqa: F401

__all__ = ["ReduceOp", "all_gather", "all_reduce", "alltoall", "barrier",
           "broadcast", "get_group", "new_group", "recv", "reduce",
           "reduce_scatter", "scatter", "send", "split", "split_group",
           "wait", "ParallelEnv",
           "get_rank", "get_world_size", "init_parallel_env",
           "DataParallel", "sync_params_buffers", "spawn", "fleet",
           "meta_parallel", "sharding", "checkpoint"]
