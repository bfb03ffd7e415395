"""``PixelShuffle``, ``PixelUnshuffle`` and ``ChannelShuffle`` (port of
``paddle_tpu/nn/layers/vision.py``)."""
from __future__ import annotations

from .. import functional as F
from ..layer import Layer

__all__ = ["PixelShuffle", "PixelUnshuffle", "ChannelShuffle"]


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor = upscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.downscale_factor = downscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self.downscale_factor, self.data_format)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups = groups
        self.data_format = data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)
