"""Hybrid-parallel wrappers (reference: ``fleet/meta_parallel/``):
``ShardingParallel`` (ZeRO) and the hybrid optimizer and grad scaler.
``TensorParallel`` and ``PipelineParallel`` wait in ROADMAP.md (Queue 1,
item 15) and raise ``NotImplementedError``."""
from .hybrid_optimizer import (HybridParallelGradScaler,  # noqa: F401
                               HybridParallelOptimizer)
from .sharding_parallel import (ShardingParallel,  # noqa: F401
                                opt_state_shardings, shard_spec_for)

__all__ = ["ShardingParallel", "shard_spec_for", "opt_state_shardings",
           "HybridParallelOptimizer", "HybridParallelGradScaler",
           "TensorParallel", "PipelineParallel"]


def _waits(name):
    raise NotImplementedError(
        f"{name} is not ported yet: tensor and pipeline parallelism wait in "
        f"ROADMAP.md (Queue 1, item 15)")


class TensorParallel:
    def __init__(self, layers, hcg=None, strategy=None):
        _waits("TensorParallel")


class PipelineParallel:
    def __init__(self, layers, hcg=None, strategy=None):
        _waits("PipelineParallel")
