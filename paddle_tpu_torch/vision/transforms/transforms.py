"""Vision transforms (port of ``paddle_tpu/vision/transforms/
transforms.py``): host-side preprocessing in numpy, run where the data is
loaded. The random ones draw from Python's ``random`` as the reference's
do, so ``random.seed(s)`` gives the same crop, flip and jitter in both."""
from __future__ import annotations

import numbers
import random

import numpy as np


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class BaseTransform:
    def __call__(self, img):
        return self._apply_image(img)


def _chw(img):
    return img if img.ndim == 3 else img[None]


class ToTensor(BaseTransform):
    def __init__(self, data_format="CHW", keys=None):
        self.data_format = data_format

    def _apply_image(self, img):
        img = np.asarray(img)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        if img.ndim == 2:
            img = img[None]
        elif (img.ndim == 3 and img.shape[-1] in (1, 3, 4)
              and self.data_format == "CHW"):
            img = np.transpose(img, (2, 0, 1))
        return img.astype(np.float32)


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False,
                 keys=None):
        if isinstance(mean, numbers.Number):
            mean = [mean] * 3
        if isinstance(std, numbers.Number):
            std = [std] * 3
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)
        self.data_format = data_format

    def _apply_image(self, img):
        img = np.asarray(img, dtype=np.float32)
        c = img.shape[0] if self.data_format == "CHW" else img.shape[-1]
        mean = self.mean[:c]
        std = self.std[:c]
        if self.data_format == "CHW":
            return (img - mean[:, None, None]) / std[:, None, None]
        return (img - mean) / std


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear", keys=None):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def _apply_image(self, img):
        from .functional import resize_array
        chw = img.ndim == 3 and img.shape[0] in (1, 3, 4)
        if chw:
            h_ax, w_ax = 1, 2
        else:
            h_ax, w_ax = 0, 1
        new_shape = list(img.shape)
        new_shape[h_ax], new_shape[w_ax] = self.size
        return resize_array(img, tuple(new_shape), "linear")


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def _apply_image(self, img):
        chw = img.ndim == 3 and img.shape[0] in (1, 3, 4)
        h, w = img.shape[1:3] if chw else img.shape[:2]
        th, tw = self.size
        i = max((h - th) // 2, 0)
        j = max((w - tw) // 2, 0)
        if chw:
            return img[:, i:i + th, j:j + tw]
        return img[i:i + th, j:j + tw]


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False, keys=None):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = padding

    def _apply_image(self, img):
        chw = img.ndim == 3 and img.shape[0] in (1, 3, 4)
        if self.padding:
            p = self.padding if isinstance(self.padding, (list, tuple)) \
                else [self.padding] * 4
            pad_cfg = [(0, 0), (p[1], p[3]), (p[0], p[2])] if chw \
                else [(p[1], p[3]), (p[0], p[2])] + (
                    [(0, 0)] if img.ndim == 3 else [])
            img = np.pad(img, pad_cfg)
        h, w = img.shape[1:3] if chw else img.shape[:2]
        th, tw = self.size
        i = random.randint(0, max(h - th, 0))
        j = random.randint(0, max(w - tw, 0))
        if chw:
            return img[:, i:i + th, j:j + tw]
        return img[i:i + th, j:j + tw]


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        self.prob = prob

    def _apply_image(self, img):
        if random.random() < self.prob:
            chw = img.ndim == 3 and img.shape[0] in (1, 3, 4)
            return img[:, :, ::-1].copy() if chw else img[:, ::-1].copy()
        return img


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        self.prob = prob

    def _apply_image(self, img):
        if random.random() < self.prob:
            chw = img.ndim == 3 and img.shape[0] in (1, 3, 4)
            return img[:, ::-1, :].copy() if chw else img[::-1].copy()
        return img


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        self.order = order

    def _apply_image(self, img):
        return np.transpose(img, self.order)


class BrightnessTransform(BaseTransform):
    def __init__(self, value, keys=None):
        self.value = value

    def _apply_image(self, img):
        factor = 1.0 + random.uniform(-self.value, self.value)
        return np.clip(img * factor, 0, 1.0 if img.dtype != np.uint8 else 255)


class ContrastTransform(BaseTransform):
    """Random contrast jitter in [max(0,1-value), 1+value] (reference
    transforms.py ContrastTransform)."""

    def __init__(self, value, keys=None):
        if value < 0:
            raise ValueError("contrast value must be non-negative")
        self.value = value

    def _apply_image(self, img):
        from . import functional as Fv
        if self.value == 0:
            return img
        factor = random.uniform(max(0, 1 - self.value), 1 + self.value)
        return Fv.adjust_contrast(img, factor)


class SaturationTransform(BaseTransform):
    def __init__(self, value, keys=None):
        if value < 0:
            raise ValueError("saturation value must be non-negative")
        self.value = value

    def _apply_image(self, img):
        from . import functional as Fv
        if self.value == 0:
            return img
        factor = random.uniform(max(0, 1 - self.value), 1 + self.value)
        return Fv.adjust_saturation(img, factor)


class HueTransform(BaseTransform):
    def __init__(self, value, keys=None):
        if not 0 <= value <= 0.5:
            raise ValueError("hue value must be in [0, 0.5]")
        self.value = value

    def _apply_image(self, img):
        from . import functional as Fv
        if self.value == 0:
            return img
        return Fv.adjust_hue(img, random.uniform(-self.value, self.value))


class ColorJitter(BaseTransform):
    """Randomly jitter brightness/contrast/saturation/hue in random order
    (reference transforms.py ColorJitter)."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 keys=None):
        self.transforms = []
        if brightness:
            self.transforms.append(BrightnessTransform(brightness))
        if contrast:
            self.transforms.append(ContrastTransform(contrast))
        if saturation:
            self.transforms.append(SaturationTransform(saturation))
        if hue:
            self.transforms.append(HueTransform(hue))

    def _apply_image(self, img):
        order = list(self.transforms)
        random.shuffle(order)
        for t in order:
            img = t(img)
        return img


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1, keys=None):
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        from . import functional as Fv
        return Fv.to_grayscale(img, self.num_output_channels)


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant", keys=None):
        self.padding = padding
        self.fill = fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        from . import functional as Fv
        return Fv.pad(img, self.padding, self.fill, self.padding_mode)


class RandomResizedCrop(BaseTransform):
    """Crop a random area/aspect patch then resize (reference transforms.py
    RandomResizedCrop: scale=(0.08,1), ratio=(3/4,4/3), 10 attempts then
    center fallback)."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3. / 4, 4. / 3),
                 interpolation="bilinear", keys=None):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation

    def _get_param(self, h, w):
        import math
        area = h * w
        for _ in range(10):
            target_area = area * random.uniform(*self.scale)
            log_ratio = (math.log(self.ratio[0]), math.log(self.ratio[1]))
            aspect = math.exp(random.uniform(*log_ratio))
            tw = int(round(math.sqrt(target_area * aspect)))
            th = int(round(math.sqrt(target_area / aspect)))
            if 0 < tw <= w and 0 < th <= h:
                i = random.randint(0, h - th)
                j = random.randint(0, w - tw)
                return i, j, th, tw
        # fallback: center crop at clamped aspect
        in_ratio = w / h
        if in_ratio < self.ratio[0]:
            tw, th = w, int(round(w / self.ratio[0]))
        elif in_ratio > self.ratio[1]:
            th, tw = h, int(round(h * self.ratio[1]))
        else:
            tw, th = w, h
        return (h - th) // 2, (w - tw) // 2, th, tw

    def _apply_image(self, img):
        from . import functional as Fv
        arr = img if not hasattr(img, "size") or isinstance(img, np.ndarray) \
            else None
        if arr is None:  # PIL
            w, h = img.size
        else:
            h, w = np.asarray(img).shape[:2]
        i, j, th, tw = self._get_param(h, w)
        out = Fv.crop(img, i, j, th, tw)
        return Fv.resize(out, self.size, self.interpolation)


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0, keys=None):
        if isinstance(degrees, numbers.Number):
            if degrees < 0:
                raise ValueError("degrees must be non-negative")
            self.degrees = (-degrees, degrees)
        else:
            self.degrees = tuple(degrees)
        self.interpolation = interpolation
        self.expand = expand
        self.center = center
        self.fill = fill

    def _apply_image(self, img):
        from . import functional as Fv
        angle = random.uniform(*self.degrees)
        return Fv.rotate(img, angle, self.interpolation, self.expand,
                         self.center, self.fill)
