"""paddle_tpu_torch.incubate (port of ``paddle_tpu/incubate``): the
mixture-of-experts layer. ``asp``, ``checkpoint``, ``operators`` and
``optimizer`` are Queue 1 item 21 (ROADMAP.md)."""
from .moe import ExpertFFN, MoELayer, top2_gating  # noqa: F401

__all__ = ["ExpertFFN", "MoELayer", "top2_gating"]
