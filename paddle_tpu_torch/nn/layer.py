"""Layer: the module base class, an ``nn.Module``.

Port of ``paddle_tpu/nn/layer.py``. PyTorch's module system already has
what the reference builds by hand (parameters, sublayers, buffers,
``train``/``eval``, ``state_dict``), so ``Layer`` adds only:

- ``create_parameter(shape, dtype, initializer, is_bias, attr,
  trainable)`` with the reference's defaults (``Constant(0)`` for biases,
  ``XavierUniform`` for weights) and its precedence: the ``ParamAttr``'s
  (or ``Initializer`` attr's) initializer, else the global one
  (``initializer.set_global_initializer``), else ``initializer``;
- the Paddle surface: ``state_dict(include_sublayers,
  structured_name_prefix)`` (parameters, each once, then persistable
  buffers, by structured name; called with torch's keywords or with none
  it is ``nn.Module.state_dict`` as it was), ``set_state_dict``/
  ``load_dict`` (returns ``(missing, unexpected)``, raises on a shape
  mismatch), ``register_forward_post_hook`` (``nn.Module``'s forward
  hook: ``hook(layer, inputs, output)``, a non-None return replaces the
  output; the pre-hook is ``nn.Module``'s own, ``hook(layer, inputs)``),
  each returning a handle with ``remove()``; ``clear_gradients`` and
  ``full_name``;
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


_PADDLE_STATE_KW = ("include_sublayers", "structured_name_prefix")


class Layer(nn.Module):
    """Base class of the port's modules (reference: nn/layer.py Layer)."""

    def create_parameter(self, shape, dtype=None, initializer=None,
                         is_bias: bool = False, attr=None,
                         trainable: bool = True, name=None) -> nn.Parameter:
        from .initializer import (Constant, ParamAttr, XavierUniform,
                                  global_initializer, initializer_of)
        from ..framework.dtype import convert_dtype
        dtype = convert_dtype(dtype) if dtype is not None else \
            torch.get_default_dtype()
        init = initializer_of(attr, None) or global_initializer(is_bias) \
            or initializer
        if init is None:
            init = Constant(0.0) if is_bias else XavierUniform()
        p = nn.Parameter(init(tuple(shape), dtype))
        if isinstance(attr, ParamAttr):
            trainable = trainable and attr.trainable
            p.optimize_attr = {"learning_rate": attr.learning_rate}
        p.requires_grad_(bool(trainable))
        return p

    # -- the Paddle surface ---------------------------------------------------
    def full_name(self) -> str:
        """A unique name of this layer, ``<class name in lower case>_<n>``
        (taken on first use)."""
        name = self.__dict__.get("_full_name")
        if name is None:
            from ..framework.naming import unique_name
            name = self.__dict__["_full_name"] = unique_name(
                type(self).__name__.lower())
        return name

    def clear_gradients(self):
        for p in self.parameters():
            p.grad = None

    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, output)`` after each forward, in
        registration order; a non-None return replaces the output.
        Returns a handle whose ``remove()`` drops the hook."""
        return self.register_forward_hook(hook)

    def state_dict(self, *args, **kwargs):
        """Paddle's form, ``state_dict(include_sublayers=True,
        structured_name_prefix="")``: the parameters (each once, in
        ``named_parameters`` order) then the persistable buffers, by
        structured name, detached. Called with torch's arguments
        (``destination``, ``prefix``, ``keep_vars``) or with none it is
        ``nn.Module.state_dict``, which the module tree's recursion
        uses."""
        paddle = any(k in kwargs for k in _PADDLE_STATE_KW) or (
            args and isinstance(args[0], bool))
        if not paddle:
            return super().state_dict(*args, **kwargs)
        include = kwargs.pop("include_sublayers", args[0] if args else True)
        prefix = kwargs.pop("structured_name_prefix",
                            args[1] if len(args) > 1 else "")
        out = OrderedDict(
            (k, v.detach()) for k, v in self.named_parameters(
                prefix=prefix, recurse=include))
        mods = self.named_modules(prefix=prefix) if include \
            else [(prefix, self)]
        for mp, m in mods:
            for name, b in m._buffers.items():
                if b is None or name in m._non_persistent_buffers_set:
                    continue
                out[(mp + "." if mp else "") + name] = b.detach()
        return out

    @torch.no_grad()
    def set_state_dict(self, state_dict, use_structured_name: bool = True):
        """Copy ``state_dict``'s entries (tensors or arrays) into the
        parameters and persistable buffers of the same names, each keeping
        its dtype and device -> ``(missing, unexpected)``: own names the
        dict lacks, the dict's names this layer lacks. A shape mismatch
        raises."""
        own = OrderedDict(self.named_parameters())
        for mp, m in self.named_modules():
            for name, b in m._buffers.items():
                if b is not None and name not in m._non_persistent_buffers_set:
                    own[(mp + "." if mp else "") + name] = b
        missing = [k for k in own if k not in state_dict]
        unexpected = [k for k in state_dict if k not in own]
        for name, t in own.items():
            if name in state_dict:
                _copy_into(t, state_dict[name], name)
        return missing, unexpected

    load_dict = set_state_dict

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
