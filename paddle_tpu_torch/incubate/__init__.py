"""paddle_tpu_torch.incubate (port of ``paddle_tpu/incubate``): the
mixture-of-experts layer and the auto-checkpoint (``checkpoint``).
``asp``, ``operators`` and ``optimizer`` are Queue 1 item 21e
(ROADMAP.md)."""
from .moe import ExpertFFN, MoELayer, top2_gating  # noqa: F401
from . import checkpoint  # noqa: F401,E402

__all__ = ["ExpertFFN", "MoELayer", "top2_gating", "checkpoint"]
