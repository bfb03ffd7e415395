"""paddle_tpu_torch.distributed.fleet — ``utils`` (recompute and the fused
gradient all-reduce)."""
from . import utils  # noqa: F401

__all__ = ["utils"]
