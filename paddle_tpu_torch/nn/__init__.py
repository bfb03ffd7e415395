"""paddle_tpu_torch.nn — the module surface: ``Layer`` (an ``nn.Module``),
``Parameter`` and ``ParamAttr``, the initializers, the functionals
(``nn.functional``), the layers (common, containers, activations,
convolutions, losses, normalization, pooling, recurrent, transformer,
vision), the decoders, and the gradient clips, each at the JAX package's
module path and with every name ``paddle_tpu.nn`` exports."""
from torch.nn import Parameter  # noqa: F401

from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from .decode import BeamSearchDecoder, Decoder, dynamic_decode  # noqa: F401
from .initializer import ParamAttr  # noqa: F401
from .layer import Layer  # noqa: F401
from .layers.activation import *  # noqa: F401,F403
from .layers.activation import __all__ as _activation
from .layers.common import *  # noqa: F401,F403
from .layers.common import __all__ as _common
from .layers.container import (LayerDict, LayerList,  # noqa: F401
                               ParameterList, Sequential)
from .layers.conv import *  # noqa: F401,F403
from .layers.conv import __all__ as _conv
from .layers.loss import *  # noqa: F401,F403
from .layers.loss import __all__ as _loss
from .layers.norm import (BatchNorm, BatchNorm1D, BatchNorm2D,  # noqa: F401
                          BatchNorm3D, GroupNorm, InstanceNorm1D,
                          InstanceNorm2D, InstanceNorm3D, LayerNorm,
                          LocalResponseNorm, SpectralNorm, SyncBatchNorm)
from .layers.pooling import *  # noqa: F401,F403
from .layers.pooling import __all__ as _pooling
from .layers.rnn import *  # noqa: F401,F403
from .layers.rnn import __all__ as _rnn
from .layers.transformer import *  # noqa: F401,F403
from .layers.transformer import __all__ as _transformer
from .layers.vision import *  # noqa: F401,F403
from .layers.vision import __all__ as _vision
from ..optimizer.clip import (ClipGradByGlobalNorm,  # noqa: F401,E402
                              ClipGradByNorm, ClipGradByValue)

__all__ = (["functional", "initializer", "Layer", "Parameter", "ParamAttr",
            "Sequential", "LayerList", "ParameterList", "LayerDict",
            "BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
            "SyncBatchNorm", "LayerNorm", "GroupNorm", "InstanceNorm1D",
            "InstanceNorm2D", "InstanceNorm3D", "LocalResponseNorm",
            "SpectralNorm", "Decoder", "BeamSearchDecoder",
            "dynamic_decode", "ClipGradByGlobalNorm", "ClipGradByNorm",
            "ClipGradByValue"] + list(_activation) + list(_common)
           + list(_conv) + list(_loss) + list(_pooling) + list(_rnn)
           + list(_transformer) + list(_vision))
