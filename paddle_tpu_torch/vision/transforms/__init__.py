"""paddle_tpu_torch.vision.transforms (port of
``paddle_tpu/vision/transforms``): the transform classes and the
functional ops, host code in numpy."""
from . import functional  # noqa: F401
from .functional import (  # noqa: F401
    adjust_brightness, adjust_contrast, adjust_hue, adjust_saturation,
    center_crop, crop, hflip, normalize, pad, resize, rotate, to_grayscale,
    to_tensor, vflip)
from .transforms import (  # noqa: F401
    BaseTransform, BrightnessTransform, CenterCrop, ColorJitter, Compose,
    ContrastTransform, Grayscale, HueTransform, Normalize, Pad, RandomCrop,
    RandomHorizontalFlip, RandomResizedCrop, RandomRotation,
    RandomVerticalFlip, Resize, SaturationTransform, ToTensor, Transpose)
