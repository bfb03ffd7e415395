"""Vision datasets (port of ``paddle_tpu/vision/datasets.py``; reference
python/paddle/vision/datasets/): ``FakeData``, the deterministic synthetic
dataset of tests and benchmarks. MNIST, CIFAR, the folder datasets,
Flowers and VOC2012 are Queue 1 item 22 (ROADMAP.md).
"""
from __future__ import annotations

import numpy as np

from ..io.dataset import Dataset

__all__ = ["FakeData"]


class FakeData(Dataset):
    """Sample ``idx`` is ``RandomState(seed + idx)``'s draw: a float32
    image of ``image_shape`` in [0, 1) (through ``transform`` when given)
    and an int64 label below ``num_classes``, the reference's draw, so both
    packages give the same samples."""

    def __init__(self, size=1024, image_shape=(1, 28, 28), num_classes=10,
                 transform=None, seed=0):
        self.size = size
        self.image_shape = tuple(image_shape)
        self.num_classes = num_classes
        self.transform = transform
        self.seed = seed

    def __getitem__(self, idx):
        rng = np.random.RandomState(self.seed + idx)
        img = rng.rand(*self.image_shape).astype(np.float32)
        label = np.asarray(rng.randint(0, self.num_classes), dtype=np.int64)
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return self.size
