"""The model zoo (port of ``paddle_tpu/vision/models``): the ResNet
family."""
from .resnet import (BasicBlock, BottleneckBlock, ResNet,  # noqa: F401
                     resnet18, resnet34, resnet50, resnet101, resnet152)

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "resnet18", "resnet34",
           "resnet50", "resnet101", "resnet152"]
