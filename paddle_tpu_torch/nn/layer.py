"""Layer: the module base class, an ``nn.Module``.

Port of ``paddle_tpu/nn/layer.py``. PyTorch's module system already has
what the reference builds by hand (parameters, sublayers, buffers,
``train``/``eval``, ``state_dict``), so ``Layer`` adds only:

- ``create_parameter(shape, dtype, initializer, is_bias)`` with the
  reference's defaults (``Constant(0)`` for biases, ``XavierUniform`` for
  weights);
- ``set_state_dict_from_numpy(state, mesh=None)``: loads the reference's
  ``{structured_name: array}`` (``paddle_tpu.nn.Layer.state_dict()``) 1:1.
  Name sets must be equal, else it raises. A parameter that this rank
  holds a piece of (its ``pspec`` names a ``model`` or ``pipe`` axis of
  the mesh larger than 1: a tensor-parallel slice, a pipeline stage's
  members of a ``stack{g}``) takes its piece of the reference's whole
  array (``distributed.mesh.local_piece``, by this rank's mesh
  coordinates); every other shape must be equal.

Beside it, :func:`set_trainer_state_from_numpy` loads a reference
``ParallelTrainer``'s whole ``state`` (as numpy) into the port's trainer:
parameters and buffers, optimizer step and slots, this rank's row of the
replica-major error-feedback residuals (``comm_err``) and the NaN guard's
and loss scaler's state, each cut to this rank's piece as the trainer
holds it.

Names are the reference's: the module tree is built in the same order,
``Linear.weight`` keeps the reference's ``(in, out)`` layout, and a tied
weight (the GPT head's) is registered once, under its owner's name, as the
reference's ``named_parameters`` dedupes by identity. ``bfloat16()`` and
``float()`` are ``nn.Module``'s: they cast every floating parameter and
buffer in place and keep no master copy, as the reference's ``astype``.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

__all__ = ["Layer", "set_trainer_state_from_numpy"]


def _as_tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):    # e.g. framework_io's bfloat16
        return value.detach().cpu().clone()
    arr = np.asarray(value)
    if arr.dtype.kind not in "fiub" or arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)   # bfloat16 arrives as an ml_dtypes type
    return torch.from_numpy(np.array(arr, copy=True))


class Layer(nn.Module):
    """Base class of the port's modules (reference: nn/layer.py Layer)."""

    def create_parameter(self, shape, dtype=None, initializer=None,
                         is_bias: bool = False) -> nn.Parameter:
        from .initializer import Constant, XavierUniform
        dtype = dtype or torch.get_default_dtype()
        if initializer is None:
            initializer = Constant(0.0) if is_bias else XavierUniform()
        return nn.Parameter(initializer(tuple(shape), dtype))

    def named_state(self) -> Dict[str, torch.Tensor]:
        """Parameters (each once) then persistent buffers, by structured
        name: the reference's ``state_dict`` keys and order."""
        out = OrderedDict(self.named_parameters())
        out.update(self.state_dict(keep_vars=True))
        return out

    @torch.no_grad()
    def set_state_dict_from_numpy(self, state: Mapping[str, object],
                                  mesh=None):
        """Copy the reference's ``{name: array}`` into this layer's
        parameters and buffers, keeping each one's dtype and device; a
        split parameter takes this rank's piece (``mesh``: the current
        one when None)."""
        from ..distributed.mesh import local_piece
        own = self.named_state()
        missing = sorted(set(own) - set(state))
        unexpected = sorted(set(state) - set(own))
        if missing or unexpected:
            raise ValueError(f"state names differ: missing {missing}, "
                             f"unexpected {unexpected}")
        for name, t in own.items():
            v = _as_tensor(state[name])
            if tuple(v.shape) != tuple(t.shape):
                v = local_piece(v, getattr(t, "pspec", None), mesh)
            if tuple(v.shape) != tuple(t.shape):
                raise ValueError(f"shape mismatch for {name}: got "
                                 f"{tuple(v.shape)}, expected "
                                 f"{tuple(t.shape)}")
            t.copy_(v.to(dtype=t.dtype))
        return self


@torch.no_grad()
def _copy_into(dst: torch.Tensor, value, name: str):
    v = _as_tensor(value)
    if tuple(v.shape) != tuple(dst.shape):
        raise ValueError(f"shape mismatch for {name}: got {tuple(v.shape)}, "
                         f"expected {tuple(dst.shape)}")
    dst.copy_(v.to(dtype=dst.dtype))


def _load_tree(dst, src, path):
    if isinstance(dst, dict):
        if set(dst) != set(src):
            raise ValueError(f"{path}: keys differ: {sorted(dst)} vs "
                             f"{sorted(src)}")
        for k in dst:
            _load_tree(dst[k], src[k], f"{path}.{k}")
    else:
        _copy_into(dst, src, path)


def set_trainer_state_from_numpy(trainer, state: Mapping[str, object]):
    """Load a reference ``ParallelTrainer.state`` (its leaves as numpy
    arrays) into the port's ``trainer`` in place.

    ``state["params"]`` and ``state["buffers"]`` go through the model's
    :meth:`Layer.set_state_dict_from_numpy` (on the trainer's mesh);
    ``state["opt"]`` must have the port optimizer's structure (``step``
    and ``slots``; a slot of a split parameter takes the parameter's piece,
    a ZeRO slot this rank's slice); ``comm_err[k]`` is replica-major,
    ``(R, *shape)``, and this rank takes row ``trainer.reduce_rank``, cut
    to its piece; ``state["guard"]`` holds ``skipped`` and, with a scaler,
    ``amp`` (``scale``, ``good``, ``bad``)."""
    from ..distributed.mesh import local_piece
    mesh = trainer.mesh
    trainer.model.set_state_dict_from_numpy(
        {**state["params"], **state.get("buffers", {})}, mesh)
    opt = dict(state["opt"])
    slots = {}
    for k, d in opt.get("slots", {}).items():
        spec = getattr(trainer.params.get(k), "pspec", None)
        slots[k] = {}
        for s, v in d.items():
            v = local_piece(_as_tensor(v), spec, mesh)
            dim = trainer.slot_dims.get(k, {}).get(s)
            if dim is not None and k in trainer._update_dims:
                v = trainer._slice(v, dim)
            slots[k][s] = v
    if "slots" in opt:
        opt["slots"] = slots
    _load_tree(trainer.opt_state, opt, "opt")
    comm_err = state.get("comm_err", {})
    if set(comm_err) != set(trainer.comm_err):
        raise ValueError(f"comm_err names differ: {sorted(comm_err)} vs "
                         f"{sorted(trainer.comm_err)}")
    for k, rows in comm_err.items():
        row = _as_tensor(np.asarray(rows)[trainer.reduce_rank])
        _copy_into(trainer.comm_err[k],
                   local_piece(row, getattr(trainer.params[k], "pspec",
                                            None), mesh), f"comm_err.{k}")
    guard = state.get("guard", {})
    if "skipped" in guard:
        _copy_into(trainer.skipped, guard["skipped"], "guard.skipped")
    if trainer.amp is not None:
        _load_tree(trainer.amp, guard["amp"], "guard.amp")
    return trainer
