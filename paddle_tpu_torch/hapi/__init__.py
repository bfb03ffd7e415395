"""paddle_tpu_torch.hapi (port of ``paddle_tpu/hapi``; reference
python/paddle/hapi/): the high-level ``Model`` with its callbacks and
``summary``/``flops``."""
from . import callbacks, model_summary  # noqa: F401
from .model import Model  # noqa: F401
from .model_summary import flops, summary  # noqa: F401

__all__ = ["callbacks", "model_summary", "Model", "flops", "summary"]
