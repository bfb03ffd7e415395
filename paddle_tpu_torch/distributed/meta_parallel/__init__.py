"""Hybrid-parallel wrappers (reference: ``fleet/meta_parallel/``):
``TensorParallel`` (the Megatron layers of ``parallel_layers``),
``PipelineParallel`` (GPipe and 1F1B over ``PipelineLayer``),
``ShardingParallel`` (ZeRO), the hybrid optimizer and grad scaler, and
``LocalSGDTrainer``."""
from .hybrid_optimizer import (HybridParallelGradScaler,  # noqa: F401
                               HybridParallelOptimizer)
from .localsgd import LocalSGDTrainer  # noqa: F401
from .parallel_layers.mp_layers import (  # noqa: F401
    ColumnParallelLinear, ParallelColumnLinearWithGeluFused,
    ParallelCrossEntropy, RowParallelLinear, VocabParallelEmbedding)
from .parallel_layers.pp_layers import (  # noqa: F401
    LayerDesc, PipelineLayer, SegmentLayers, SharedLayerDesc)
from .pipeline_parallel import PipelineParallel  # noqa: F401
from .sharding_parallel import (ShardingParallel,  # noqa: F401
                                opt_state_shardings, shard_spec_for)
from .tensor_parallel import TensorParallel  # noqa: F401

__all__ = ["ShardingParallel", "shard_spec_for", "opt_state_shardings",
           "HybridParallelOptimizer", "HybridParallelGradScaler",
           "TensorParallel", "PipelineParallel", "ColumnParallelLinear",
           "RowParallelLinear", "VocabParallelEmbedding",
           "ParallelCrossEntropy", "ParallelColumnLinearWithGeluFused",
           "LayerDesc", "SharedLayerDesc", "SegmentLayers", "PipelineLayer",
           "LocalSGDTrainer"]
