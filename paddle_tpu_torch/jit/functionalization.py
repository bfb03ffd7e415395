"""Functionalization bridge: a Layer as a pure function of its state.

Port of ``paddle_tpu/jit/functionalization.py``. The reference swaps
traced values into a layer's parameter boxes by hand; PyTorch does that in
``torch.func.functional_call``, so this module is its thin wrapper:
``state_of(layer)`` gives the ``(params, buffers)`` name -> tensor dicts,
and ``functional_call(layer, params, buffers, *args)`` runs the unchanged
``forward`` on them and returns ``(outputs, new_buffers)``. ``jit.save``
exports exactly this function, with the state as inputs.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Tuple

import torch

__all__ = ["state_of", "trainable_mask", "functional_call"]


def state_of(layer) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(parameters, buffers) as flat name -> tensor dicts, in the layer's
    order (a tied parameter once, under its first name)."""
    params = OrderedDict(layer.named_parameters())
    buffers = OrderedDict(layer.named_buffers())
    return params, buffers


def trainable_mask(layer) -> Dict[str, bool]:
    return OrderedDict((n, p.requires_grad)
                       for n, p in layer.named_parameters())


def functional_call(layer, params, buffers, *args, rng=None, **kwargs):
    """Run ``layer(*args, **kwargs)`` on ``params`` and ``buffers`` in
    place of the layer's own; returns ``(outputs, new_buffers)``. Buffers
    the forward updates in place (running statistics) are read back from
    the tensors passed in. ``rng`` (a ``torch.Generator``'s state, as
    ``get_state()`` gives it) seeds the CPU generator for the call and
    restores it after, so dropout is deterministic."""
    params = dict(params or {})
    buffers = OrderedDict(buffers if buffers is not None
                          else layer.named_buffers())
    state = {**params, **buffers}
    if rng is not None:
        with torch.random.fork_rng(devices=[]):
            torch.set_rng_state(rng)
            out = torch.func.functional_call(layer, state, args, kwargs,
                                             tie_weights=True)
    else:
        out = torch.func.functional_call(layer, state, args, kwargs,
                                         tie_weights=True)
    return out, buffers
