"""paddle_tpu_torch.nn — the module surface: ``Layer`` (an ``nn.Module``),
the initializers, the functionals (``nn.functional``) and the layers
(common, containers, activations, convolutions, pooling, normalization),
each at the JAX package's module path."""
from . import functional  # noqa: F401
from .layer import Layer  # noqa: F401
from .layers.activation import *  # noqa: F401,F403
from .layers.activation import __all__ as _activation
from .layers.common import Dropout, Embedding, Linear  # noqa: F401
from .layers.container import (LayerDict, LayerList,  # noqa: F401
                               ParameterList, Sequential)
from .layers.conv import *  # noqa: F401,F403
from .layers.conv import __all__ as _conv
from .layers.norm import (BatchNorm, BatchNorm1D, BatchNorm2D,  # noqa: F401
                          BatchNorm3D, GroupNorm, InstanceNorm1D,
                          InstanceNorm2D, InstanceNorm3D, LayerNorm,
                          LocalResponseNorm, SpectralNorm, SyncBatchNorm)
from .layers.pooling import *  # noqa: F401,F403
from .layers.pooling import __all__ as _pooling

__all__ = (["functional", "Layer", "Dropout", "Embedding", "Linear",
            "Sequential", "LayerList", "ParameterList", "LayerDict",
            "BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
            "SyncBatchNorm", "LayerNorm", "GroupNorm", "InstanceNorm1D",
            "InstanceNorm2D", "InstanceNorm3D", "LocalResponseNorm",
            "SpectralNorm"] + list(_activation) + list(_conv)
           + list(_pooling))
