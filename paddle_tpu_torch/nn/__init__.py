"""paddle_tpu_torch.nn — the module surface of the GPT training path.

``Layer`` (an ``nn.Module``), the initializers, the functionals
(``nn.functional``) and the layers ``Linear``, ``Embedding``, ``Dropout``,
``LayerList`` and ``LayerNorm``, each at the JAX package's module path.
"""
from . import functional  # noqa: F401
from .layer import Layer  # noqa: F401
from .layers.common import Dropout, Embedding, Linear  # noqa: F401
from .layers.container import LayerList  # noqa: F401
from .layers.norm import LayerNorm  # noqa: F401

__all__ = ["functional", "Layer", "Dropout", "Embedding", "Linear",
           "LayerList", "LayerNorm"]
