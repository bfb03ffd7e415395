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

Staging (``to_static``, ``TracedLayer``): the reference runs the
dy2static AST pass (:mod:`.dy2static`) and stages with ``jax.jit``. The
port runs the same pass and stages with ``torch.fx``: the converted
function is traced once per input signature (shapes, dtypes, devices,
the grad mode) by ``make_fx(tracing_mode="fake")`` into a
``torch.fx.GraphModule`` (:func:`trace_graph`), which is then executed
on the real tensors. Nothing is generated: the graph's nodes are ATen
ops, the port's kernel ops (one node each) and the ``cond`` /
``while_loop`` higher-order ops of converted control flow. A layer's
parameters and buffers are graph inputs, read at every call, so an
update of the weights is seen without a new trace.
"""
from __future__ import annotations

import functools
import json
import os
import pickle
import threading
import types
import warnings
from collections import namedtuple
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from .._device import resolve_device
from ..framework_io import _from_saved, _to_saveable
from .functionalization import (functional_call, state_of,  # noqa: F401
                                trainable_mask)

__all__ = ["InputSpec", "TracedLayer", "TranslatedLayer", "StaticFunction",
           "to_static", "trace_graph", "save", "load", "read_pdiparams",
           "poly_arg_specs", "not_to_static", "set_verbosity",
           "set_code_level", "ProgramTranslator", "EXAMPLE_BATCH",
           "MAX_DYNAMIC_DIM"]

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


# -- staging: dy2static + torch.fx ---------------------------------------------

class LostGradientError(RuntimeError):
    """A staged graph would drop a gradient the eager call has."""


def _function_spy():
    """A context that records the ``torch.autograd.Function`` classes the
    traced code applies to tensors that need a gradient. ``make_fx``
    inlines such a Function's forward, so a replay of the graph has no
    way to its ``backward``. Functions of torch itself are left out: a
    registered op's autograd (the flash kernels', the CE losses', the
    ring's and the sharded lookup's) is one of them, and its node keeps
    it."""
    import contextlib
    seen = []
    fn_cls = torch.autograd.Function
    orig = fn_cls.__dict__["apply"]

    def apply(cls, *args, **kwargs):
        if torch.is_grad_enabled() and not cls.__module__.startswith(
                "torch.") and any(
                isinstance(t, torch.Tensor) and t.requires_grad
                for t in list(args) + list(kwargs.values())):
            if cls.__name__ not in seen:
                seen.append(cls.__name__)
        return orig.__func__(cls, *args, **kwargs)

    @contextlib.contextmanager
    def spying():
        fn_cls.apply = classmethod(apply)
        try:
            yield seen
        finally:
            fn_cls.apply = orig

    return spying()


def trace_graph(fn, *args):
    """``fn(*args)`` traced once on fakes of ``args`` into a
    ``torch.fx.GraphModule`` of ATen ops, kernel ops and control-flow
    ops; returns ``(graph, lost)`` where ``lost`` names the
    ``autograd.Function``s whose backward a replay of the graph would
    lose (:func:`_function_spy`). Tensors ``fn`` closes over are taken as
    they are (constants of the graph); nothing is allocated or launched."""
    from torch.fx.experimental.proxy_tensor import make_fx

    from .dy2static import _Substitute

    def traced(*a):
        # a staged loop's counter may index a tensor (``x[i]``)
        with _Substitute({}):
            return fn(*a)

    with _function_spy() as lost:
        graph = make_fx(traced, tracing_mode="fake",
                        _allow_non_fake_inputs=True)(*args)
    return graph, list(lost)


def _signature(values) -> tuple:
    sig = [torch.is_grad_enabled()]
    for v in values:
        if isinstance(v, torch.Tensor):
            sig.append((tuple(v.shape), v.dtype, v.device.type,
                        v.device.index, v.requires_grad))
        else:
            sig.append(("py", repr(v)))
    return tuple(sig)


class StaticFunction:
    """A function after the dy2static pass, staged once per input
    signature and executed as its graph (reference:
    program_translator.py:232 StaticFunction)."""

    def __init__(self, fn, input_spec=None):
        from .dy2static import convert_function
        self._dygraph_function = fn
        self._converted = convert_function(fn)
        self.input_spec = input_spec
        self._graphs = {}
        functools.update_wrapper(self, fn, updated=())

    def _entry(self, args, kwargs):
        leaves, spec = pytree.tree_flatten((args, kwargs))
        key = (_signature(leaves), str(spec))
        entry = self._graphs.get(key)
        if entry is None:
            tensors = [i for i, v in enumerate(leaves)
                       if isinstance(v, torch.Tensor)]
            conv = self._converted

            def pure(*ts):
                full = list(leaves)
                for j, i in enumerate(tensors):
                    full[i] = ts[j]
                a, k = pytree.tree_unflatten(full, spec)
                return conv(*a, **k)

            graph, lost = trace_graph(pure, *[leaves[i] for i in tensors])
            entry = (graph, tensors, lost)
            self._graphs[key] = entry
        return entry, leaves

    def graph(self, *args, **kwargs) -> "torch.fx.GraphModule":
        """The staged graph for these inputs (traced on first use)."""
        return self._entry(args, kwargs)[0][0]

    def __call__(self, *args, **kwargs):
        (graph, tensors, lost), leaves = self._entry(args, kwargs)
        if lost:
            raise LostGradientError(
                f"to_static({self._dygraph_function.__name__}): the staged "
                f"graph would lose the backward of {lost}, a plain "
                "autograd.Function (the experts' exchanges, the Megatron "
                "operators); trace the value and its gradients together "
                "(static.append_backward in a static.Program) or call it "
                "under torch.no_grad()")
        return graph(*[leaves[i] for i in tensors])

    @property
    def dygraph_function(self):
        return self._dygraph_function


class TracedLayer:
    """A Layer staged through ``torch.fx``: callable with the layer's
    signature, traced once per input signature and then executed as its
    graph. The parameters and buffers are inputs of the graph, read from
    the layer at every call (``refresh_state`` re-reads which tensors
    they are, after a parameter is replaced), never constants of the
    trace. Buffers the forward updates in place (running statistics) are
    updated in place by the graph too.

    Called with gradients enabled, the result carries the autograd of the
    graph's ATen ops and of the kernel ops; a graph that would drop a
    gradient the eager layer has (an ``autograd.Function`` whose forward
    the trace inlined) raises :class:`LostGradientError` naming it."""

    def __init__(self, layer, input_spec=None):
        self.layer = layer
        self.input_spec = input_spec
        self._graphs = {}
        self.refresh_state()

    def refresh_state(self):
        self._params, self._buffers = state_of(self.layer)

    def _entry(self, args, kwargs):
        leaves, spec = pytree.tree_flatten((args, kwargs))
        pnames, bnames = list(self._params), list(self._buffers)
        state = list(self._params.values()) + list(self._buffers.values())
        key = (_signature(state + leaves), str(spec), self.layer.training,
               tuple(pnames), tuple(bnames))
        entry = self._graphs.get(key)
        if entry is None:
            tensors = [i for i, v in enumerate(leaves)
                       if isinstance(v, torch.Tensor)]
            layer, n_p, n_s = self.layer, len(pnames), len(state)

            def pure(*ts):
                params = dict(zip(pnames, ts[:n_p]))
                buffers = dict(zip(bnames, ts[n_p:n_s]))
                full = list(leaves)
                for j, i in enumerate(tensors):
                    full[i] = ts[n_s + j]
                a, k = pytree.tree_unflatten(full, spec)
                return functional_call(layer, params, buffers, *a, **k)[0]

            graph, lost = trace_graph(
                pure, *state, *[leaves[i] for i in tensors])
            entry = (graph, tensors, lost)
            self._graphs[key] = entry
        return entry, state, leaves

    def graph(self, *args, **kwargs) -> "torch.fx.GraphModule":
        """The staged graph for these inputs (traced on first use). Its
        inputs are the parameters, the buffers, then the tensor inputs."""
        return self._entry(args, kwargs)[0][0]

    def __call__(self, *args, **kwargs):
        (graph, tensors, lost), state, leaves = self._entry(args, kwargs)
        if lost:
            raise LostGradientError(
                f"TracedLayer({type(self.layer).__name__}): the staged graph "
                f"would lose the backward of {lost}, a plain "
                "autograd.Function whose forward the trace inlines (the "
                "experts' exchanges, the Megatron operators); trace the "
                "loss and its gradients together (static.append_backward "
                "in a static.Program) or call the layer under "
                "torch.no_grad()")
        return graph(*state, *[leaves[i] for i in tensors])

    @property
    def forward(self):
        return self.__call__


def to_static(layer_or_fn=None, input_spec=None, **kwargs):
    """Decorator/wrapper: the dy2static AST pass, then staging (reference:
    paddle.jit.to_static -> program_translator.py:232 StaticFunction).
    Python if/while/for-range over traced tensors become ``cond`` /
    ``while_loop`` nodes of the staged graph. A Layer's ``forward`` is
    replaced by its converted form (so the layer itself runs the converted
    code eagerly, and ``jit.save`` exports it) and a :class:`TracedLayer`
    of it is returned; a function gives a :class:`StaticFunction`. With
    ``ProgramTranslator().enable(False)`` the object comes back as it
    was. ``kwargs`` (the reference's ``jax.jit`` keywords) are accepted
    and unused."""

    def wrap(obj):
        from ..nn.layer import Layer
        if not ProgramTranslator.enable_to_static:
            return obj
        if isinstance(obj, (Layer, torch.nn.Module)):
            from .dy2static import convert_function
            try:
                converted = convert_function(type(obj).forward)
                obj.forward = types.MethodType(converted, obj)
            except Exception as e:  # uncovered shape: stage the original
                warnings.warn(
                    f"dy2static: AST conversion of "
                    f"{type(obj).__name__}.forward failed ({e}); staging "
                    "the original forward (tensor-dependent Python control "
                    "flow will fail to trace)")
            return TracedLayer(obj, input_spec)
        return StaticFunction(obj, input_spec)

    if layer_or_fn is None:
        return wrap
    return wrap(layer_or_fn)


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
    """Singleton (reference dygraph_to_static/program_translator.py:232).
    ``enable(False)`` turns staging off: ``to_static`` then returns the
    original callable unchanged."""

    _instance = None
    enable_to_static = True

    @classmethod
    def get_instance(cls):
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def enable(self, enable_to_static: bool):
        ProgramTranslator.enable_to_static = bool(enable_to_static)
