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

:class:`RNGStatesTracker` (:func:`get_rng_state_tracker`) holds named
streams for tensor-parallel dropout (reference
``fleet/meta_parallel/parallel_layers/random.py:24``): inside
``tracker.rng_state(name)`` every :func:`get_generator` draw comes from
that name's own generator of the device, seeded by the number given to
``add`` and kept between the scopes.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Union

import torch

__all__ = ["seed", "get_generator", "draw_seed", "RNGStatesTracker",
           "get_rng_state_tracker"]

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
    """The generator of ``device``, made from the global seed on first use
    (inside ``RNGStatesTracker.rng_state(name)``: that name's)."""
    device = torch.device(device)
    key = _key(device)
    if _scope.names:
        return _rng_tracker._generator(_scope.names[-1], key)
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


class _Scope(threading.local):
    def __init__(self):
        self.names = []


_scope = _Scope()


class RNGStatesTracker:
    """Named RNG streams for tensor-parallel dropout (reference
    ``framework/random.py:79``): model-parallel ranks draw identical masks
    for replicated activations (the global generator) and different ones
    for sharded activations (a stream seeded per rank)."""

    def __init__(self):
        self.states_: Dict[str, int] = {}
        self._gens: Dict[tuple, torch.Generator] = {}

    def add(self, name: str, s: int):
        if name in self.states_:
            raise ValueError(f"state {name!r} already exists")
        self.states_[name] = int(s)

    def reset(self):
        self.states_ = {}
        self._gens = {}

    def _generator(self, name: str, key: str) -> torch.Generator:
        g = self._gens.get((name, key))
        if g is None:
            g = torch.Generator(device=key)
            g.manual_seed(self.states_[name])
            self._gens[(name, key)] = g
        return g

    @contextlib.contextmanager
    def rng_state(self, name: str = "model_parallel_rng"):
        if name not in self.states_:
            raise ValueError(f"state {name!r} not added")
        _scope.names.append(name)
        try:
            yield
        finally:
            _scope.names.pop()


_rng_tracker = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    return _rng_tracker
