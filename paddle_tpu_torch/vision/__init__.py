"""paddle_tpu_torch.vision (port of ``paddle_tpu/vision``): the model zoo's
ResNet family. Transforms, ``vision.ops`` and the other models are Queue
1 item 21b, datasets item 22 (ROADMAP.md)."""
from . import models  # noqa: F401

__all__ = ["models"]
