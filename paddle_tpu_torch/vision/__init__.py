"""paddle_tpu_torch.vision (port of ``paddle_tpu/vision``): the model zoo
(LeNet, the MobileNets, the ResNet family, VGG), ``vision.ops`` (the
detection ops, ``deform_conv2d``), ``vision.transforms`` and the image
backend. Datasets are Queue 1 item 22 (ROADMAP.md)."""
from . import models, ops, transforms  # noqa: F401
from .models import LeNet  # noqa: F401

__all__ = ["models", "ops", "transforms", "LeNet", "set_image_backend",
           "get_image_backend", "image_load"]

_image_backend = "pil"


def set_image_backend(backend: str):
    """The backend :func:`image_load` reads with: ``"pil"`` or
    ``"cv2"``."""
    global _image_backend
    if backend not in ("pil", "cv2"):
        raise ValueError(f"unsupported image backend {backend!r}")
    _image_backend = backend


def get_image_backend() -> str:
    return _image_backend


def image_load(path, backend=None):
    """Load an image file with ``backend`` (default: the configured one);
    PIL or cv2 is imported here, when it is asked for."""
    backend = backend or _image_backend
    if backend == "cv2":
        try:
            import cv2
        except ImportError as e:
            raise ImportError("cv2 backend requested but not installed") \
                from e
        return cv2.imread(str(path))
    from PIL import Image
    return Image.open(path)
