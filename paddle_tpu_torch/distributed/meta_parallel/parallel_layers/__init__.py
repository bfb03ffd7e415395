"""The tensor- and pipeline-parallel layers (reference
``fleet/meta_parallel/parallel_layers/``)."""
from .mp_layers import (ColumnParallelLinear,  # noqa: F401
                        ParallelColumnLinearWithGeluFused,
                        ParallelCrossEntropy, RowParallelLinear,
                        VocabParallelEmbedding)
from .pp_layers import (LayerDesc, PipelineLayer,  # noqa: F401
                        SegmentLayers, SharedLayerDesc)
