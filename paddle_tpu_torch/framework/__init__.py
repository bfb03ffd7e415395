"""paddle_tpu_torch.framework — the random state (``random``), the dtype
registry (``dtype``) and unique names (``naming``)."""
from . import dtype, naming  # noqa: F401
from .dtype import get_default_dtype, set_default_dtype  # noqa: F401
from .naming import unique_name  # noqa: F401
from .random import draw_seed, get_generator, seed  # noqa: F401

__all__ = ["seed", "get_generator", "draw_seed", "dtype", "naming",
           "get_default_dtype", "set_default_dtype", "unique_name"]
