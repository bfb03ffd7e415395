"""paddle_tpu_torch.incubate (port of ``paddle_tpu/incubate``): the
mixture-of-experts layer, the auto-checkpoint (``checkpoint``), n:m
sparsity (``asp``), the masked softmax (``operators``) and the
``LookAhead``/``ModelAverage`` optimizers (``optimizer``)."""
from .moe import ExpertFFN, MoELayer, top2_gating  # noqa: F401
from . import asp  # noqa: F401,E402
from . import checkpoint  # noqa: F401,E402
from .operators import softmax_mask_fuse_upper_triangle  # noqa: F401,E402
from .optimizer import LookAhead, ModelAverage  # noqa: F401,E402

__all__ = ["ExpertFFN", "MoELayer", "top2_gating", "asp", "checkpoint",
           "softmax_mask_fuse_upper_triangle", "LookAhead", "ModelAverage"]
