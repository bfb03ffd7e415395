"""paddle_tpu_torch.distributed — data parallelism over
``torch.distributed``: the environment (``env``), the mesh (``mesh``), the
collectives (``collective``), the compressed gradient exchange
(``compressed``), ``DataParallel``, ``spawn``, ``fleet.utils``,
``engine.ParallelTrainer`` and ``checkpoint`` (the trainer's state on
disk)."""
from .collective import (ReduceOp, all_gather, all_reduce,  # noqa: F401
                         alltoall, barrier, broadcast, get_group, new_group,
                         recv, reduce, reduce_scatter, scatter, send, wait)
from .env import (ParallelEnv, get_rank, get_world_size,  # noqa: F401
                  init_parallel_env)
from .parallel import DataParallel, sync_params_buffers  # noqa: F401
from .spawn import spawn  # noqa: F401
from . import fleet  # noqa: F401

__all__ = ["ReduceOp", "all_gather", "all_reduce", "alltoall", "barrier",
           "broadcast", "get_group", "new_group", "recv", "reduce",
           "reduce_scatter", "scatter", "send", "wait", "ParallelEnv",
           "get_rank", "get_world_size", "init_parallel_env",
           "DataParallel", "sync_params_buffers", "spawn", "fleet"]
