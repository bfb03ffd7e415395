"""paddle_tpu_torch.framework — the random state (``random``)."""
from .random import draw_seed, get_generator, seed  # noqa: F401

__all__ = ["seed", "get_generator", "draw_seed"]
