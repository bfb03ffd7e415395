"""paddle_tpu_torch.nn.functional — activations, attention, common,
convolutions, extensions, losses, normalization, pooling and vision, with
every name ``paddle_tpu.nn.functional`` exports."""
from .activation import *  # noqa: F401,F403
from .activation import __all__ as _activation
from .attention import scaled_dot_product_attention  # noqa: F401
from .common import *  # noqa: F401,F403
from .common import __all__ as _common
from .conv import *  # noqa: F401,F403
from .conv import __all__ as _conv
from .extension import diag_embed, gather_tree, temporal_shift  # noqa: F401
from .loss import *  # noqa: F401,F403
from .loss import __all__ as _loss
from .norm import *  # noqa: F401,F403
from .norm import __all__ as _norm
from .pooling import *  # noqa: F401,F403
from .pooling import __all__ as _pooling
from .vision import *  # noqa: F401,F403
from .vision import __all__ as _vision

__all__ = (list(_activation) + ["scaled_dot_product_attention",
                                "diag_embed", "gather_tree",
                                "temporal_shift"]
           + list(_common) + list(_conv) + list(_loss) + list(_norm)
           + list(_pooling) + list(_vision))
