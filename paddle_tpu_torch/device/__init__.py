"""paddle_tpu_torch.device (port of ``paddle_tpu/device``; reference
python/paddle/device.py: ``set_device``, ``get_device``, the
``is_compiled_with_*`` queries, the Place classes of fluid/core).

A place is a ``torch.device`` (``Place.torch_device``): ``CPUPlace`` and
``CUDAPinnedPlace`` the host, ``CUDAPlace(i)`` card ``i``. ``TPUPlace``,
``XPUPlace`` and ``NPUPlace`` name the accelerator, the card here, as the
reference maps each to its default accelerator. Device strings are
Paddle's: ``"gpu:0"``, ``"gpu"``, ``"cpu"``.

``set_device`` sets the default device of every entry point
(``_device.resolve_device(None)``). Unlike the reference, which swallows
the error, ``set_device("gpu")`` without a card raises: the port never
falls back to the CPU on its own.
"""
from __future__ import annotations

import numpy as _np
import torch

from .._device import default_device, resolve_device, set_default_device

__all__ = ["Place", "CPUPlace", "CUDAPlace", "CUDAPinnedPlace", "TPUPlace",
           "XPUPlace", "NPUPlace", "get_device", "set_device",
           "get_all_device_type", "get_available_device",
           "get_available_custom_device", "device_count", "synchronize",
           "cuda", "get_cudnn_version", "is_compiled_with_cuda",
           "is_compiled_with_tpu", "is_compiled_with_xpu",
           "is_compiled_with_npu", "is_compiled_with_rocm",
           "get_cuda_rng_state", "set_cuda_rng_state"]


class Place:
    """A device handle (reference platform/place.h); ``torch_device``
    is the ``torch.device`` it names."""

    _type = None     # None: the card

    def __init__(self, device_id: int = 0):
        self._device_id = int(device_id)

    def get_device_id(self) -> int:
        return self._device_id

    @property
    def torch_device(self) -> torch.device:
        if self._type == "cpu":
            return torch.device("cpu")
        return resolve_device(torch.device("cuda", self._device_id))

    def __eq__(self, other):
        return (type(self) is type(other)
                and self._device_id == other._device_id)

    def __hash__(self):
        return hash((type(self).__name__, self._device_id))

    def __repr__(self):
        kind = self._type or "gpu"
        return f"Place({kind}:{self._device_id})"


class CPUPlace(Place):
    _type = "cpu"

    def __init__(self):
        super().__init__(0)


class TPUPlace(Place):
    """The accelerator: card ``device_id``."""


class CUDAPlace(TPUPlace):
    """Card ``device_id``."""


class CUDAPinnedPlace(CPUPlace):
    """Pinned host memory: the host (``pin_memory`` is a tensor's own)."""


class XPUPlace(TPUPlace):
    """Accepted for source compat; the card."""


class NPUPlace(TPUPlace):
    """Accepted for source compat; the card."""


def _parse(device: str) -> torch.device:
    kind, _, idx = str(device).partition(":")
    if kind in ("gpu", "cuda", "tpu", "xpu", "npu"):
        return torch.device("cuda", int(idx) if idx else 0)
    if kind == "cpu":
        return torch.device("cpu")
    raise ValueError(f"unknown device {device!r}: expected 'cpu', 'gpu' "
                     "or 'gpu:<id>'")


def get_device() -> str:
    """``"gpu:<id>"`` when the default device is a card that is present,
    else ``"cpu"`` (reference device.py:193)."""
    dev = torch.device(default_device())
    if dev.type != "cuda" or not torch.cuda.is_available():
        return "cpu"
    return f"gpu:{resolve_device(dev).index}"


def set_device(device) -> str:
    """Make ``device`` (``"gpu"``, ``"gpu:1"``, ``"cpu"``, a Place or a
    ``torch.device``) the default of every entry point; returns
    :func:`get_device`. A card that is not present raises."""
    if isinstance(device, Place):
        dev = device.torch_device
    elif isinstance(device, torch.device):
        dev = device
    else:
        dev = _parse(device)
    if dev.type == "cuda":
        dev = resolve_device(dev)       # no card raises: nothing changes
        torch.cuda.set_device(dev)
    set_default_device(dev)
    return get_device()


def get_all_device_type():
    return sorted({"cpu"} | ({"gpu"} if torch.cuda.is_available()
                             else set()))


def get_available_device():
    if torch.cuda.is_available():
        return [f"gpu:{i}" for i in range(torch.cuda.device_count())]
    return ["cpu:0"]


def get_available_custom_device():
    return []


def device_count() -> int:
    """The cards present, or 1 (the host) without one, as the reference
    counts the devices of its default backend."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def synchronize(device=None):
    """Wait for the card's queued work (reference
    paddle.device.cuda.synchronize); nothing to wait on without a card."""
    if torch.cuda.is_available():
        torch.cuda.synchronize(None if device is None else
                               _parse(device) if isinstance(device, str)
                               else device)


class cuda:  # namespace: paddle.device.cuda.*
    @staticmethod
    def device_count():
        return torch.cuda.device_count() if torch.cuda.is_available() else 0

    @staticmethod
    def synchronize(device=None):
        synchronize(device)

    @staticmethod
    def empty_cache():
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def get_cudnn_version():
    """cuDNN's version number with a card, else None (reference
    device.py:62)."""
    if not torch.cuda.is_available():
        return None
    return torch.backends.cudnn.version()


def is_compiled_with_cuda() -> bool:
    """True when torch was built with CUDA."""
    return torch.version.cuda is not None


def is_compiled_with_tpu() -> bool:
    return False


def is_compiled_with_xpu() -> bool:
    return False


def is_compiled_with_npu() -> bool:
    return False


def is_compiled_with_rocm() -> bool:
    return False


def get_cuda_rng_state():
    """The state of each card's generator (``framework.random``), one
    entry a card (none without a card); :func:`set_cuda_rng_state` puts
    it back."""
    from ..framework.random import get_generator
    if not torch.cuda.is_available():
        return []
    return [get_generator(torch.device("cuda", i)).get_state()
            for i in range(torch.cuda.device_count())]


def set_cuda_rng_state(state_list):
    from ..framework.random import get_generator
    for i, state in enumerate(state_list):
        get_generator(torch.device("cuda", i)).set_state(state)


def numpy(x):
    """A host array of ``x`` (a bfloat16 tensor as float32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return _np.asarray(x)
