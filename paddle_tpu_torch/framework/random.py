"""The port's random state: one seed, one ``torch.Generator`` per device.

Port of ``paddle_tpu/framework/random.py``'s global generator
(``paddle.seed``). JAX threads explicit keys; PyTorch draws from stateful
generators, so the port keeps one generator per device, created on first
use from the global seed and re-seeded by :func:`seed`:

- initializers draw on the CPU generator (parameters are made on the CPU
  and moved to the card by the trainer);
- ``dropout`` draws its mask on the generator of the tensor's device;
- :func:`draw_seed` draws the int32 seed of the flash kernels' in-kernel
  dropout as a device tensor, so no draw waits for the device.

The two frameworks give different numbers from the same seed: tests make
their inputs with numpy and hand them to both.
"""
from __future__ import annotations

import threading
from typing import Dict, Union

import torch

__all__ = ["seed", "get_generator", "draw_seed"]

_INT32_MAX = 2 ** 31 - 1

_lock = threading.Lock()
_seed = 0
_generators: Dict[str, torch.Generator] = {}


def _key(device: torch.device) -> str:
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return str(device)


def seed(s: int):
    """Seed every generator, present and future (paddle.seed)."""
    global _seed
    with _lock:
        _seed = int(s)
        for g in _generators.values():
            g.manual_seed(_seed)


def get_generator(device: Union[str, torch.device] = "cpu"
                  ) -> torch.Generator:
    """The generator of ``device``, made from the global seed on first use."""
    device = torch.device(device)
    key = _key(device)
    with _lock:
        g = _generators.get(key)
        if g is None:
            g = torch.Generator(device=key)
            g.manual_seed(_seed)
            _generators[key] = g
        return g


def draw_seed(device: Union[str, torch.device]) -> torch.Tensor:
    """A fresh int32 seed in [0, 2**31 - 1) as a (1,) tensor on ``device``
    (the reference draws ``randint(key, (), 0, int32 max)``)."""
    device = torch.device(device)
    return torch.randint(0, _INT32_MAX, (1,), generator=get_generator(device),
                         device=device, dtype=torch.int32)
