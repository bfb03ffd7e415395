"""``save``/``load``: one pickle file of an object tree, tensors as numpy.

Port of ``paddle_tpu/framework_io.py`` (``paddle.save``/``paddle.load``).
The format is the reference's: a pickle of the tree (dicts, lists, tuples,
scalars) with every array as a numpy array, so either package reads the
other's files without torch or jax.

bfloat16 has no numpy dtype without ``ml_dtypes``, which the reference
pickles it as and which the card's host lacks; ``torch.Tensor.numpy()``
refuses it. The port writes a bfloat16 tensor as ``{"__bfloat16__":
<uint16 array of its bits>}`` and ``load`` gives it back as a
``torch.bfloat16`` tensor (every other array stays numpy). A file the
reference wrote with bfloat16 arrays needs ``ml_dtypes`` to unpickle.

``load`` unpickles: read only files this program or the reference wrote.
For the trainer's state in a checkpoint directory, see
``distributed/checkpoint.py``.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

__all__ = ["save", "load", "BF16_TAG"]

BF16_TAG = "__bfloat16__"


def _to_saveable(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        if t.dtype == torch.bfloat16:
            return {BF16_TAG: t.contiguous().view(torch.int16).numpy()
                    .view(np.uint16).copy()}
        return t.numpy().copy()
    if isinstance(obj, dict):
        return {k: _to_saveable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = type(obj) if type(obj) in (list, tuple) else list
        return t(_to_saveable(v) for v in obj)
    return obj


def _from_saved(obj):
    if isinstance(obj, dict):
        if list(obj) == [BF16_TAG]:
            bits = np.ascontiguousarray(obj[BF16_TAG], dtype=np.uint16)
            return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
        return {k: _from_saved(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = type(obj) if type(obj) in (list, tuple) else list
        return t(_from_saved(v) for v in obj)
    return obj


def save(obj, path, protocol=4, **configs):
    """Pickle ``obj`` to ``path``, tensors as numpy (module docstring)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_saveable(obj), f, protocol=protocol)


def load(path, **configs):
    """The tree :func:`save` (or the reference's ``save``) wrote: arrays as
    numpy, bfloat16 ones as ``torch.bfloat16`` tensors."""
    with open(path, "rb") as f:
        return _from_saved(pickle.load(f))
