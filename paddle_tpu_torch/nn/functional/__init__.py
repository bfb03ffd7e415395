"""paddle_tpu_torch.nn.functional — the functionals on the GPT path."""
from .activation import gelu  # noqa: F401
from .attention import scaled_dot_product_attention  # noqa: F401
from .common import dropout, embedding, linear  # noqa: F401
from .loss import (cross_entropy, fused_linear_cross_entropy,  # noqa: F401
                   softmax_with_cross_entropy)
from .norm import layer_norm  # noqa: F401

__all__ = ["gelu", "scaled_dot_product_attention", "dropout", "embedding",
           "linear", "cross_entropy", "softmax_with_cross_entropy",
           "fused_linear_cross_entropy", "layer_norm"]
