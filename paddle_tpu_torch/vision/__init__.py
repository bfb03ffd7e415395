"""paddle_tpu_torch.vision (port of ``paddle_tpu/vision``): the model zoo's
ResNet family. Datasets, transforms, ``vision.ops`` and the other models
are Queue 1 items 21–22 (ROADMAP.md)."""
from . import models  # noqa: F401

__all__ = ["models"]
