"""Device resolution shared by the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "default_device", "set_default_device"]

# what ``device=None`` means: the card, unless ``paddle_tpu_torch.
# set_device`` named another
_default = "cuda"


def default_device() -> str:
    return _default


def set_default_device(device: Union[str, torch.device]):
    """The device ``resolve_device(None)`` resolves from now on
    (``paddle_tpu_torch.set_device`` checks that a card is present
    first)."""
    global _default
    _default = str(torch.device(device))


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """``None`` means the default device: the card, or what
    ``set_device`` chose. Raises when a CUDA device is asked for (or
    defaulted to) and none is present — the port never falls back to the
    CPU on its own; callers that want the CPU pass ``device="cpu"``."""
    dev = torch.device(_default if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device present: pass device='cpu' to run on the CPU")
        if dev.index is None:   # one spelling per card, so devices compare
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
