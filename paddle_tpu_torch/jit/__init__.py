"""paddle_tpu_torch.jit — export and load.

Port of ``paddle_tpu/jit/__init__.py`` (``InputSpec``, ``save``, ``load``,
``TranslatedLayer`` and the dy2static compatibility surface). The
reference exports StableHLO through ``jax.export``; the port exports a
``torch.export`` program:

- ``save(layer, prefix, input_spec)`` exports the layer as a pure function
  of ``(params, buffers, *inputs)`` (:mod:`.functionalization`) and writes
  two files: ``<prefix>.pt2``, the program (``torch.export.save``, no
  weights in it), and ``<prefix>.pdiparams``, the reference's pickle of
  ``{"params": {name: array}, "buffers": {name: array}}``, so that a
  quantized view (``inference.quant``) swaps the weights without
  exporting again. bfloat16 arrays are written as ``framework_io`` writes
  them (``{"__bfloat16__": <uint16 bits>}``).
- A dim given as ``None``/``-1`` in an ``InputSpec`` becomes a
  ``torch.export.Dim``, named as the reference names its symbols
  (:func:`poly_arg_specs`): dim 0 of every unnamed spec shares one
  ``batch`` Dim; a named spec scopes its Dims by its name. The reference
  traces with batch 1; ``torch.export`` specialises a dim of size 1, so
  the port traces with :data:`EXAMPLE_BATCH` (2) rows.
- The program is tied to the device it was exported on (a traced program
  holds device constants): ``.pt2`` records it, ``load`` places the
  weights there and raises when asked for another device.
- The flash forward is a registered op (``ops.flash_attention``); ``save``
  exports under ``flash_attention.exporting()`` so the CPU's program
  holds the op as the card's does, and ``load`` imports ``ops`` first so
  ``torch.export.load`` finds it.

:func:`read_pdiparams` reads a ``.pdiparams`` file, the reference's too,
into ``{name: array}`` for ``Layer.set_state_dict_from_numpy``: that is
how a model saved by the JAX package is saved again by the port.
``to_static`` and ``TracedLayer`` (dy2static) wait for ROADMAP Queue 1
item 21 and raise.
"""
from __future__ import annotations

import json
import os
import pickle
import threading
from collections import namedtuple
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..framework_io import _from_saved, _to_saveable
from .functionalization import (functional_call, state_of,  # noqa: F401
                                trainable_mask)

__all__ = ["InputSpec", "TracedLayer", "TranslatedLayer", "to_static",
           "save", "load", "read_pdiparams", "poly_arg_specs",
           "not_to_static", "set_verbosity", "set_code_level",
           "ProgramTranslator", "EXAMPLE_BATCH", "MAX_DYNAMIC_DIM"]

# rows of the example inputs a dynamic dim is traced with (1 specialises)
EXAMPLE_BATCH = 2
# the largest size a dynamic dim may take (torch.export needs a bound at
# which every guard the trace makes still holds; the flash gate asks for
# batch * heads <= 65535)
MAX_DYNAMIC_DIM = 2048
_FORMAT = 1
_META = "paddle_tpu_torch.json"

ShapeDtype = namedtuple("ShapeDtype", ["shape", "dtype"])

_DTYPES = {"float32": torch.float32, "float": torch.float32,
           "float64": torch.float64, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "int64": torch.int64,
           "int32": torch.int32, "int16": torch.int16, "int8": torch.int8,
           "uint8": torch.uint8, "bool": torch.bool}


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    if name not in _DTYPES:
        raise ValueError(f"InputSpec: unsupported dtype {dtype!r}")
    return _DTYPES[name]


class InputSpec:
    """reference: python/paddle/static/input.py InputSpec. ``None`` or -1
    marks a dynamic dim."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = tuple(-1 if s is None else int(s) for s in shape)
        self.dtype = _torch_dtype(dtype)
        self.name = name

    def to_shape_dtype(self, batch_size=EXAMPLE_BATCH) -> ShapeDtype:
        return ShapeDtype(tuple(batch_size if s == -1 else s
                                for s in self.shape), self.dtype)

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype}, "
                f"name={self.name!r})")


def _dynamic_names(input_spec) -> list:
    """Per input, None or ``{dim: symbol name}``: the reference's naming
    (``jit/__init__.py:112-143``)."""
    out = []
    for i, s in enumerate(input_spec):
        if isinstance(s, InputSpec) and any(d == -1 for d in s.shape):
            tag = s.name or None
            names = {}
            for j, d in enumerate(s.shape):
                if d != -1:
                    continue
                if j == 0:
                    names[j] = f"{tag}_batch" if tag else "batch"
                else:
                    names[j] = f"{tag}_d{j}" if tag else f"d{i}_{j}"
            out.append(names)
        else:
            out.append(None)
    return out


def poly_arg_specs(input_spec) -> list:
    """``torch.export`` dynamic shapes for the inputs: per input, None
    (static) or ``{dim: Dim}``. One ``Dim`` object per symbol name, so
    dim 0 of every unnamed spec is the same ``batch`` Dim (forward may
    combine two dynamic-batch inputs) and a named spec's Dims are its
    own (``<name>_batch``, ``<name>_d<j>``); other unnamed dims are
    ``d<i>_<j>``. Each ranges over [1, :data:`MAX_DYNAMIC_DIM`]."""
    dims: Dict[str, object] = {}
    out = []
    for names in _dynamic_names(input_spec):
        if names is None:
            out.append(None)
            continue
        spec = {}
        for j, name in names.items():
            if name not in dims:
                dims[name] = torch.export.Dim(name, min=1,
                                              max=MAX_DYNAMIC_DIM)
            spec[j] = dims[name]
        out.append(spec)
    return out


def _example_args(input_spec: Optional[Sequence], device) -> tuple:
    if input_spec is None:
        raise ValueError("jit.save requires input_spec for tracing")
    args = []
    for s in input_spec:
        if isinstance(s, InputSpec):
            sd = s.to_shape_dtype(EXAMPLE_BATCH)
            args.append(torch.zeros(sd.shape, dtype=sd.dtype, device=device))
        else:
            args.append(torch.as_tensor(np.asarray(s), device=device))
    return tuple(args)


class _Pure(torch.nn.Module):
    """``(params, buffers, *args) -> layer's outputs``. The layer is held
    outside the module tree, so the exported program owns no weights."""

    def __init__(self, layer):
        super().__init__()
        self.__dict__["_layer"] = layer

    def forward(self, params, buffers, *args):
        out, _ = functional_call(self._layer, params, buffers, *args)
        return out


def _state_device(params, buffers) -> torch.device:
    for t in list(params.values()) + list(buffers.values()):
        return t.device
    return torch.device("cpu")


def _host_tree(state) -> dict:
    return {k: _to_saveable(v) for k, v in state.items()}


def save(layer, path, input_spec=None, **configs):
    """Export ``layer`` to ``<path>.pt2`` and its weights to
    ``<path>.pdiparams`` (reference: fluid/dygraph/jit.py:515). Traced on
    the device the layer's weights are on, in eval mode, without
    gradients."""
    from ..ops import flash_attention

    layer.eval()
    params, buffers = state_of(layer)
    # plain dicts: the program's input tree is what the caller passes
    params = {k: v.detach() for k, v in params.items()}
    buffers = {k: v.detach() for k, v in buffers.items()}
    device = _state_device(params, buffers)
    args = _example_args(input_spec, device)
    # the forward's *args are one tuple to torch.export
    dynamic = ({k: None for k in params}, {k: None for k in buffers},
               tuple(poly_arg_specs(input_spec)))
    with torch.no_grad(), flash_attention.exporting():
        exported = torch.export.export(_Pure(layer),
                                       (params, buffers, *args),
                                       dynamic_shapes=dynamic, strict=False)
    # the example inputs hold the weights: keep them out of the program
    exported.example_inputs = None
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    meta = {"format": _FORMAT, "device": str(device), "inputs": len(args),
            "torch": torch.__version__}
    torch.export.save(exported, path + ".pt2",
                      extra_files={_META: json.dumps(meta)})
    with open(path + ".pdiparams", "wb") as f:
        pickle.dump({"params": _host_tree(params),
                     "buffers": _host_tree(buffers)}, f, protocol=4)


def _read_state(path: str) -> Tuple[dict, dict]:
    if not path.endswith(".pdiparams"):
        path = path + ".pdiparams"
    with open(path, "rb") as f:
        blob = _from_saved(pickle.load(f))
    return dict(blob["params"]), dict(blob.get("buffers", {}))


def read_pdiparams(path: str) -> Dict[str, object]:
    """``{name: array}`` of a ``.pdiparams`` file (``path`` with or
    without the suffix): parameters then buffers, numpy arrays (a port
    file's bfloat16 ones as ``torch.bfloat16`` tensors). Reads the
    reference's files as its own; a reference file holding bfloat16
    arrays needs ``ml_dtypes`` to unpickle. Unpickles: read only files
    this program or the reference wrote."""
    params, buffers = _read_state(path)
    return {**params, **buffers}


def _to_device(state: dict, device) -> dict:
    out = {}
    for k, v in state.items():
        t = v if isinstance(v, torch.Tensor) else \
            torch.from_numpy(np.array(v, copy=True))
        out[k] = t.to(device)
    return out


class TranslatedLayer:
    """A loaded program and its weights (reference: fluid/dygraph/io.py
    :1082). Called with arrays or tensors, which are copied to its
    device; runs without gradients."""

    #: a weight-quantized view's stats (``inference.quant``), else None
    quant_stats = None

    def __init__(self, exported, params, buffers, device=None):
        self._exported = exported
        self._params = params
        self._buffers = buffers
        self.device = torch.device(device) if device is not None else \
            _state_device(params, buffers)
        self._module = None
        self._lock = threading.Lock()

    def _callable(self):
        with self._lock:
            if self._module is None:
                self._module = self._exported.module()
            return self._module

    def __call__(self, *args):
        fn = self._callable()
        args = [a.to(self.device) if isinstance(a, torch.Tensor) else
                torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for a in args]
        with torch.no_grad():
            return fn(self._params, self._buffers, *args)

    forward = __call__

    def eval(self):
        return self

    def parameters(self):
        return list(self._params.values())


def load(path, device=None, **configs) -> TranslatedLayer:
    """Load ``<path>.pt2`` and ``<path>.pdiparams`` onto the device the
    program was exported on. ``device`` (optional) must name that device:
    the program is never moved to another one (ValueError); a program of
    the card raises without one."""
    from .. import ops  # noqa: F401  (registers the ops the program calls)
    from ..ops import flash_attention  # noqa: F401

    extra = {_META: ""}
    exported = torch.export.load(path + ".pt2", extra_files=extra)
    meta = json.loads(extra[_META] or "{}")
    home = torch.device(meta.get("device", "cpu"))
    if device is not None and torch.device(device).type != home.type:
        raise ValueError(f"{path}.pt2 was exported on {home}; it runs "
                         f"there only (asked for {device}): save it again "
                         f"on {device}")
    home = resolve_device(home)
    params, buffers = _read_state(path)
    return TranslatedLayer(exported, _to_device(params, home),
                           _to_device(buffers, home), device=home)


# -- dy2static: not ported (ROADMAP Queue 1 item 21) --------------------------

_NO_DY2STATIC = ("{} needs the dy2static pass (paddle_tpu/jit/dy2static.py), "
                 "which waits for ROADMAP Queue 1 item 21; export with "
                 "jit.save(layer, path, input_spec)")


class TracedLayer:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_NO_DY2STATIC.format("TracedLayer"))


def to_static(layer_or_fn=None, input_spec=None, **kwargs):
    raise NotImplementedError(_NO_DY2STATIC.format("jit.to_static"))


def not_to_static(fn):
    return fn


_verbosity = 0
_code_level = 0


def set_verbosity(level: int = 0, also_to_stdout: bool = False):
    """Compat with reference jit.set_verbosity: records the level."""
    global _verbosity
    _verbosity = int(level)


def set_code_level(level: int = 100, also_to_stdout: bool = False):
    """Compat with reference jit.set_code_level: records the level."""
    global _code_level
    _code_level = int(level)


class ProgramTranslator:
    """Singleton compat shim (reference dygraph_to_static/program_translator
    .py:232); ``enable`` records the flag."""

    _instance = None
    enable_to_static = True

    @classmethod
    def get_instance(cls):
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def enable(self, enable_to_static: bool):
        ProgramTranslator.enable_to_static = bool(enable_to_static)
