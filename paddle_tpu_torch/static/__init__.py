"""paddle_tpu_torch.static — the declarative (static-graph) mode.

Port of ``paddle_tpu/static/__init__.py``. Capability map (reference):

- ``Program`` / ProgramDesc            <- fluid/framework.py:4017 Program —
  here a Program IS a ``torch.fx.GraphModule`` traced by ``make_fx`` on
  fake tensors (the reference: a jaxpr); every kernel of the port is one
  node of it, control flow is ``cond`` / ``while_loop`` nodes.
- ``Executor.run(feed/fetch)``         <- fluid/executor.py:475,916 — the
  graph, traced once per scope object and feed signature and cached on
  the Program, then executed on the real tensors: its nodes launch the
  port's kernels and ATen ops, nothing is generated.
- ``append_backward``                  <- fluid/backward.py:1377 —
  ``torch.autograd.grad`` inside the traced function, so a training
  Program holds its backward ops (the flash dq/dk-dv and CE dh/dw kernel
  nodes included) and the replay needs no autograd.
- ``save/load_inference_model``        <- fluid/io.py:1246,1459 — a
  ``torch.export`` program, with the ``jit.save`` machinery's Dims.
- ``CompiledProgram``                  <- fluid/compiler.py — the Program
  itself (one device).

The network is an ordinary Python function (the same code as the eager
mode) staged by ``Program.trace(fn, *specs)``; ``static.data`` declares
the feeds, whose names bind ``feed={name: value}`` at run time. The
values a Program reads by name (``static.nn``'s parameters, variables
made with ``create_global_var``) live in a :class:`Scope` and enter the
graph as inputs, so ``static.load`` / ``set_program_state`` take effect
without a new trace; a Layer bound with ``Program.trace(...,
parameters=layer)`` lends its parameters and buffers to the graph as
inputs too.

Devices: ``Executor(place)`` runs on ``place`` (``None``: the card,
raising without one; ``"cpu"``: the CPU); feeds and the scope's values are
moved there.
"""
from __future__ import annotations

import contextlib
import copy
import os
import pickle
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .._device import resolve_device
from ..framework_io import _from_saved, _to_saveable
from ..jit import EXAMPLE_BATCH, InputSpec, trace_graph
from ..jit import _signature as _sig

__all__ = [
    "InputSpec", "data", "Program", "Executor", "CompiledProgram",
    "default_main_program", "program_guard", "append_backward", "gradients",
    "save_inference_model", "load_inference_model", "name_scope",
    "cpu_places", "device_count",
]


def data(name: str, shape, dtype="float32") -> InputSpec:
    """Declare a named feed placeholder (reference: paddle.static.data).
    Returns an InputSpec consumed by ``Program.trace``; the name binds
    ``feed={name: value}`` at run time."""
    return InputSpec(shape, dtype=dtype, name=name)


def _count_nodes(gm) -> int:
    """Call nodes, through the subgraphs of control-flow nodes (the
    reference's count through inner jaxprs)."""
    from ..analysis.walker import count_nodes
    n = count_nodes(gm)
    for sub in gm.children():
        if isinstance(sub, torch.fx.GraphModule):
            n += _count_nodes(sub)
    return n


def _layer_state(layer):
    if layer is None:
        return [], []
    names, vals = [], []
    for n, p in layer.named_parameters():
        names.append(n)
        vals.append(p)
    for n, b in layer.named_buffers():
        names.append(n)
        vals.append(b)
    return names, vals


class _Staged:
    """One traced graph of a Program, for one scope and feed signature."""

    def __init__(self, scope, graph, state_names, layer_names, n_out):
        self.scope = scope
        self.graph = graph
        self.state_names = state_names
        self.layer_names = layer_names
        self.n_out = n_out


class Program:
    """A staged computation: ordered feed specs + traced graph.

    reference: fluid/framework.py:4017. ``trace`` is the only constructor
    that populates it; an empty Program exists for program_guard parity.
    """

    def __init__(self):
        self._fn: Optional[Callable] = None
        self._specs: "OrderedDict[str, InputSpec]" = OrderedDict()
        self._graph = None
        self._fetch_names: List[str] = []
        self._compiled: Dict[tuple, _Staged] = {}
        self._layer = None
        self._name_state = None

    @classmethod
    def trace(cls, fn: Callable, *specs: InputSpec, fetch_names=None,
              static_batch: Optional[int] = None,
              parameters=None) -> "Program":
        """Capture ``fn(*tensors) -> output(s)`` as a Program. ``specs``
        come from ``static.data`` (order = positional argument order); a
        dynamic dim is traced at ``static_batch`` (default
        ``jit.EXAMPLE_BATCH``). ``parameters``: a Layer whose parameters
        and buffers ``fn`` reads, made graph inputs. The trace runs on
        fakes on the layer's device (the CPU without a layer): nothing is
        launched; an ``Executor`` on another device traces again."""
        from ..framework import naming
        prog = cls()
        prog._fn = fn
        prog._layer = parameters
        # auto-generated layer names must be IDENTICAL on every (re)trace
        # of this program, or each trace would mint a fresh parameter set
        prog._name_state = dict(naming._namer.counters)
        for i, s in enumerate(specs):
            prog._specs[s.name or f"x{i}"] = s
        _, vals = _layer_state(parameters)
        device = vals[0].device if vals else torch.device("cpu")
        feeds = [torch.zeros(s.to_shape_dtype(static_batch or EXAMPLE_BATCH)
                             .shape, dtype=s.dtype, device=device)
                 for s in specs]
        # the first trace COMMITS its counter advance (the next program
        # traced must not collide on fc_0); retraces replay
        staged = _stage(prog, global_scope(), feeds, commit=True)
        prog._graph = staged.graph
        prog._fetch_names = list(fetch_names or
                                 [f"fetch_{i}" for i in range(staged.n_out)])
        return prog

    def _naming(self, commit=False):
        """Replay the trace-time name counters (restoring after, unless
        ``commit``), so retraces bind fc_0 to the same parameters instead
        of minting fc_1."""
        from ..framework import naming
        return naming.guard(initial=self._name_state, commit=commit)

    # -- introspection (ProgramDesc analogues) ----------------------------
    @property
    def feed_names(self) -> List[str]:
        return list(self._specs)

    @property
    def fetch_names(self) -> List[str]:
        return list(self._fetch_names)

    @property
    def graph(self):
        """The ``torch.fx.GraphModule`` traced by ``trace``."""
        return self._graph

    def num_ops(self) -> int:
        """Call nodes of the graph, through control-flow subgraphs — the
        ProgramDesc op count."""
        return 0 if self._graph is None else _count_nodes(self._graph)

    def analyze(self, mesh=None, config=None):
        """The port's program analysis (``analysis.analyze_graph``) over
        this Program's graph: rule findings + cost estimate, a Report."""
        from ..analysis import Report, analyze_graph
        if self._graph is None:
            return Report()
        return analyze_graph(self._graph, mesh=mesh, config=config)

    def to_string(self, throw_on_error=True, with_details=False) -> str:
        return "<empty Program>" if self._graph is None else \
            self._graph.code

    __str__ = to_string

    def __repr__(self) -> str:
        if self._graph is None:
            return "<Program: empty>"
        try:
            summary = self.analyze().summary()
        except Exception:
            summary = "analysis unavailable"
        return (f"<Program: {len(self._specs)} feeds, "
                f"{len(self._fetch_names)} fetches, {self.num_ops()} ops; "
                f"{summary}>")

    def clone(self, for_test: bool = False) -> "Program":
        return copy.copy(self)


def _stage(program: Program, scope, feeds, commit=False) -> _Staged:
    """The graph of ``program`` for ``scope`` and these feeds: cached on
    the Program by the scope object, the feeds' signature and the names
    and signature of the scope's values; traced on a miss. Parameters a
    first trace creates (``static.nn``) land in the scope concretely; the
    trace is then made again so that they too are graph inputs."""
    layer_names, layer_vals = _layer_state(program._layer)
    for attempt in range(2):
        state = _scope_state(scope)
        names, vals = list(state), list(state.values())
        key = (id(scope), _sig(feeds), tuple(names), _sig(vals + layer_vals))
        entry = program._compiled.get(key)
        if entry is not None and entry.scope is scope:
            return entry
        n_s, n_l = len(vals), len(layer_vals)
        layer, fn = program._layer, program._fn
        out_count = []

        def pure(*flat):
            overlay = _OverlayScope(scope, dict(zip(names, flat[:n_s])))
            _scope_stack.append(overlay)
            try:
                with program._naming(commit and attempt == 0), \
                        _bound(layer, layer_names, flat[n_s:n_s + n_l]):
                    out = fn(*flat[n_s + n_l:])
            finally:
                _scope_stack.pop()
            outs = tuple(out) if isinstance(out, (tuple, list)) else (out,)
            out_count.append(len(outs))
            return outs

        graph, _ = trace_graph(pure, *vals, *layer_vals, *feeds)
        if set(_scope_state(scope)) == set(names):
            entry = _Staged(scope, graph, names, layer_names, out_count[-1])
            program._compiled[key] = entry
            return entry
    raise RuntimeError("static: the program keeps creating scope variables "
                       "on every trace")


@contextlib.contextmanager
def _bound(layer, names, values):
    if layer is None:
        yield
        return
    from torch.nn.utils.stateless import _reparametrize_module
    with _reparametrize_module(layer, dict(zip(names, values)),
                               tie_weights=True):
        yield


_default_main = Program()


def default_main_program() -> Program:
    return _default_main


def default_startup_program() -> Program:
    """Parameter init is eager here (initializers run where a parameter is
    first made); the startup program (fluid/framework.py
    default_startup_program) has no work left — returned for API
    parity."""
    return Program()


class program_guard:
    """reference: fluid/framework.py program_guard. Swaps the default main
    program; network code inside the guard should be wrapped into a
    function and staged with ``Program.trace`` (see module docstring)."""

    def __init__(self, main_program: Program,
                 startup_program: Optional[Program] = None):
        self._prog = main_program

    def __enter__(self):
        global _default_main
        self._saved = _default_main
        _default_main = self._prog
        return self._prog

    def __exit__(self, *exc):
        global _default_main
        _default_main = self._saved
        return False


def append_backward(loss_fn: Callable, wrt=0,
                    parameter_list=None) -> Callable:
    """Given a scalar-valued ``loss_fn``, return ``grad_fn`` (reference:
    fluid/backward.py:1377, which emits grad ops into the ProgramDesc):

    - ``grad_fn(*args)`` -> d loss / d args[wrt] (a tuple for a sequence
      of positions);
    - with ``parameter_list`` (a Layer, or a list of tensors that need a
      gradient): ``grad_fn(*args)`` -> ``(loss, [d loss / d p for each
      parameter])``, a parameter the loss does not reach getting zeros.
      A Layer's parameters are read when ``grad_fn`` runs, so inside a
      Program bound to it they are the graph's inputs.

    Built on ``torch.autograd.grad``: traced inside a Program, the
    backward's ops (the kernels' backward ops among them) become nodes of
    the graph."""
    if parameter_list is None:
        many = isinstance(wrt, (list, tuple))
        idx = tuple(wrt) if many else (wrt,)

        def grad_fn(*args):
            args = list(args)
            xs = []
            for i in idx:
                args[i] = torch.as_tensor(args[i]).detach().requires_grad_(
                    True)
                xs.append(args[i])
            with torch.enable_grad():
                loss = loss_fn(*args)
                gs = torch.autograd.grad(loss, xs)
            return tuple(gs) if many else gs[0]
        return grad_fn

    def grad_fn(*args):
        params = (list(parameter_list.parameters())
                  if hasattr(parameter_list, "parameters")
                  else list(parameter_list))
        with torch.enable_grad():
            loss = loss_fn(*args)
            gs = torch.autograd.grad(loss, params, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(params, gs)]
    return grad_fn


def gradients(loss_fn: Callable, wrt=0, parameter_list=None) -> Callable:
    return append_backward(loss_fn, wrt, parameter_list)


def _numpy(t):
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(t)


class Executor:
    """Session-style runner (reference: fluid/executor.py:475 Executor,
    :916 run). Stages the Program (once per scope object and feed
    signature, cached on the Program) and executes its graph on
    ``place`` (None: the card)."""

    def __init__(self, place=None):
        self.place = place
        self.device = resolve_device(place)

    def _feed(self, value):
        t = value if isinstance(value, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(np.asarray(value)))
        return t.to(self.device)

    def _place_scope(self, scope):
        """Move the scope's values onto the executor's device."""
        cur = scope
        while cur is not None:
            for k, v in list(cur._vars.items()):
                if isinstance(v, torch.Tensor) and v.device != self.device:
                    cur._vars[k] = v.to(self.device)
            cur = cur._parent

    def run(self, program: Optional[Program] = None,
            feed: Optional[dict] = None,
            fetch_list: Optional[Sequence] = None,
            return_numpy: bool = True):
        program = program or default_main_program()
        if isinstance(program, CompiledProgram):
            program = program._program
        if program._fn is None:
            raise ValueError("Program is empty — build it with "
                             "Program.trace (see paddle_tpu_torch.static)")
        feed = feed or {}
        try:
            args = [self._feed(feed[name]) for name in program.feed_names]
        except KeyError as e:
            raise KeyError(f"missing feed {e} (program feeds: "
                           f"{program.feed_names})") from None
        _, layer_vals = _layer_state(program._layer)
        for v in layer_vals:
            if v.device != self.device:
                raise ValueError(
                    f"the Program's layer lies on {v.device}, the executor "
                    f"runs on {self.device}: move the layer first")
        scope = global_scope()
        self._place_scope(scope)
        staged = _stage(program, scope, args)
        state = _scope_state(scope)
        vals = [state[n] for n in staged.state_names]
        with torch.no_grad():
            outs = staged.graph(*vals, *layer_vals, *args)
        outs = list(outs)
        if fetch_list:
            name_to_i = {n: i for i, n in enumerate(program.fetch_names)}
            sel = []
            for f in fetch_list:
                if isinstance(f, str) and f in name_to_i:
                    sel.append(outs[name_to_i[f]])
                elif isinstance(f, int):
                    sel.append(outs[f])
                else:
                    raise KeyError(f"unknown fetch {f!r} (have "
                                   f"{program.fetch_names})")
            outs = sel
        if return_numpy:
            outs = [_numpy(o) for o in outs]
        return list(outs)

    def train_from_dataset(self, program, dataset, sparse_table,
                           dense_table=None, thread: int = 2,
                           batch_size: int = 128, lr: float = 0.05,
                           worker: str = "hogwild", key_slot: str = "ids",
                           extract=None, _eval_only: bool = False,
                           **desc_kwargs):
        """reference: fluid/executor.py train_from_dataset — the
        Trainer/DeviceWorker runtime (``distributed.ps.trainer``) over a
        Dataset. ``program`` is the step callable ``(emb, dense, batch) ->
        (loss, emb_grad, dense_grad)``; the sparse side is a host table
        (``distributed.ps``). Returns the trainer's stats dict."""
        from ..distributed.ps.trainer import TrainerDesc, TrainerFactory
        desc = TrainerDesc(worker=worker, thread_num=thread,
                           batch_size=batch_size, lr=lr, **desc_kwargs)
        return TrainerFactory().create(desc).train(
            dataset, program, sparse_table, dense_table=dense_table,
            key_slot=key_slot, extract=extract, eval_only=_eval_only)

    def infer_from_dataset(self, program, dataset, sparse_table,
                           dense_table=None, thread: int = 2,
                           batch_size: int = 128, key_slot: str = "ids",
                           extract=None):
        """reference: executor.py infer_from_dataset — same worker fan-out,
        read-only: no pushes reach the tables."""
        return self.train_from_dataset(program, dataset, sparse_table,
                                       dense_table=dense_table,
                                       thread=thread, batch_size=batch_size,
                                       lr=0.0, key_slot=key_slot,
                                       extract=extract, _eval_only=True)

    def close(self):
        pass


class CompiledProgram:
    """reference: fluid/compiler.py CompiledProgram -> ParallelExecutor.
    One device here: the wrapped Program runs as it is."""

    def __init__(self, program: Program, build_strategy=None):
        self._program = program
        self.build_strategy = build_strategy

    def __getattr__(self, item):
        return getattr(self._program, item)


class _ProgramModule(torch.nn.Module):
    def __init__(self, program):
        super().__init__()
        self.__dict__["_program"] = program

    def forward(self, *feeds):
        prog = self._program
        with prog._naming(), _bound(prog._layer, *_layer_state(prog._layer)):
            out = prog._fn(*feeds)
        return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def save_inference_model(path_prefix: str, feed_vars, fetch_vars,
                         executor=None, program: Optional[Program] = None,
                         **kwargs):
    """Export a traced Program (reference: fluid/io.py:1246): a
    ``torch.export`` program at ``<prefix>.pt2`` (the scope's values are
    constants of it; dynamic dims as ``jit.save`` makes them) and the
    feed/fetch names at ``<prefix>.pdmodel``."""
    from ..jit import _example_args, poly_arg_specs
    from ..ops import flash_attention
    program = program or default_main_program()
    if program._fn is None:
        raise ValueError("Program is empty")
    specs = list(program._specs.values())
    # the device of the executor, else of the values the program reads
    _, vals = _layer_state(program._layer)
    vals += list(_scope_state(global_scope()).values())
    device = executor.device if executor is not None else (
        vals[0].device if vals else torch.device("cpu"))
    args = _example_args(specs, device)
    with torch.no_grad(), flash_attention.exporting():
        exported = torch.export.export(
            _ProgramModule(program), tuple(args),
            dynamic_shapes=(tuple(poly_arg_specs(specs)),), strict=False)
    d = os.path.dirname(path_prefix)
    if d:
        os.makedirs(d, exist_ok=True)
    torch.export.save(exported, path_prefix + ".pt2")
    with open(path_prefix + ".pdmodel", "wb") as f:
        pickle.dump({"feed_names": program.feed_names,
                     "fetch_names": program.fetch_names,
                     "device": str(device)}, f)


def load_inference_model(path_prefix: str, executor=None, **kwargs):
    """``(run, feed_names, fetch_names)`` (reference: fluid/io.py:1459);
    ``run(*feeds)`` returns the fetches as a tuple of tensors."""
    from .. import ops  # noqa: F401  (registers the kernel ops)
    exported = torch.export.load(path_prefix + ".pt2")
    with open(path_prefix + ".pdmodel", "rb") as f:
        meta = pickle.load(f)
    device = torch.device(meta.get("device", "cpu"))
    module = exported.module()

    def run(*args):
        args = [a.to(device) if isinstance(a, torch.Tensor) else
                torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in args]
        with torch.no_grad():
            return module(*args)

    return run, meta["feed_names"], meta["fetch_names"]


def name_scope(prefix: str):
    """Tag the nodes traced inside with ``{"name_scope": prefix}``
    (``node.meta["custom"]``)."""
    import torch.fx.traceback as fx_traceback
    return fx_traceback.annotate({"name_scope": prefix})


def cpu_places(device_count: Optional[int] = None):
    return [torch.device("cpu")] * (device_count or 1)


def device_count() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


# -- Scope / variable store ---------------------------------------------------
class Variable:
    """Static-graph variable handle (reference fluid/framework.py:805): it
    names an entry in a Scope; values are tensors."""

    def __init__(self, name, shape=None, dtype="float32", persistable=False):
        self.name = name
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.persistable = persistable

    def __repr__(self):
        return f"Variable(name={self.name}, shape={self.shape})"


class Scope:
    """Name -> value store (reference framework/scope.h:173: name->Variable
    map with parent chain)."""

    def __init__(self, parent: Optional["Scope"] = None):
        self._vars: Dict[str, object] = {}
        self._parent = parent

    def var(self, name: str, value=None):
        if value is not None:
            self._vars[name] = value
        else:
            self._vars.setdefault(name, None)
        return self._vars.get(name)

    def find_var(self, name: str):
        if name in self._vars:
            return self._vars[name]
        return self._parent.find_var(name) if self._parent else None

    def local_var_names(self):
        return list(self._vars)

    def new_scope(self) -> "Scope":
        return Scope(parent=self)

    def drop_kids(self):
        pass

    def __contains__(self, name):
        return self.find_var(name) is not None


_global_scope = Scope()
_scope_stack: List[Scope] = [_global_scope]


class _OverlayScope(Scope):
    """Trace-time view of a Scope: reads come from a (traced) state dict so
    scope values are graph inputs; writes (a parameter created during the
    trace, which ``static.nn`` keeps concrete) land in the base scope."""

    def __init__(self, base: Scope, state: Dict[str, object]):
        super().__init__(parent=base)
        self._base = base
        self._state = state

    def find_var(self, name: str):
        if name in self._state:
            return self._state[name]
        return self._base.find_var(name)

    def var(self, name: str, value=None):
        return self._base.var(name, value)

    def local_var_names(self):
        return list(self._state) + self._base.local_var_names()


def _scope_state(scope: Scope) -> Dict[str, object]:
    """Tensor-valued vars visible from ``scope`` (walking the parent
    chain), in a stable order."""
    state = {}
    cur = scope
    while cur is not None:
        for k in cur.local_var_names():
            if k not in state:
                v = cur.find_var(k)
                if isinstance(v, torch.Tensor):
                    state[k] = v
        cur = cur._parent
    return state


def global_scope() -> Scope:
    """reference fluid/executor.py global_scope()."""
    return _scope_stack[-1]


class scope_guard:
    """reference fluid/executor.py scope_guard."""

    def __init__(self, scope: Scope):
        self._scope = scope

    def __enter__(self):
        _scope_stack.append(self._scope)
        return self._scope

    def __exit__(self, *exc):
        _scope_stack.pop()
        return False


def fill_scope_from_numpy(state: Dict[str, object], scope=None,
                          device="cpu") -> Scope:
    """The weight carry of the static mode: write ``{name: array}`` (e.g.
    the reference scope's values, ``np.asarray`` of each) into ``scope``
    (default: the current one) as tensors on ``device``, so that a
    ``static.nn`` program computes what the reference's does."""
    scope = scope or global_scope()
    for k, v in state.items():
        t = v if isinstance(v, torch.Tensor) else \
            torch.from_numpy(np.array(v, copy=True))
        scope.var(k, t.to(device))
    return scope


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """reference fluid/layers/tensor.py create_global_var."""
    from ..framework import dtype as dtype_mod
    from ..framework.naming import unique_name
    name = name or unique_name("global_var")
    t = torch.full(tuple(shape), value, dtype=dtype_mod.convert_dtype(dtype))
    global_scope().var(name, t)
    return Variable(name, shape, dtype, persistable=persistable)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """reference static create_parameter — registers in the global scope."""
    from ..framework.naming import unique_name
    from .nn import _param
    name = name or unique_name("parameter")
    return _param(name, tuple(shape), dtype,
                  initializer=default_initializer, is_bias=is_bias)


# -- program/state serialization ---------------------------------------------
def _scope_arrays(scope) -> Dict[str, object]:
    return {k: _to_saveable(v) for k, v in _scope_state(scope).items()}


def load_program_state(model_path: str, var_list=None):
    """reference fluid/io.py load_program_state — returns name->ndarray
    (bfloat16 values as tensors)."""
    with open(model_path + ".pdparams", "rb") as f:
        state = _from_saved(pickle.load(f))
    if var_list is not None:
        names = {v.name if hasattr(v, "name") else v for v in var_list}
        state = {k: v for k, v in state.items() if k in names}
    return state


def set_program_state(program, state_dict):
    """reference fluid/io.py set_program_state — write into the global
    scope (each value keeps the device of the value it replaces)."""
    scope = global_scope()
    for k, v in state_dict.items():
        t = v if isinstance(v, torch.Tensor) else \
            torch.from_numpy(np.array(v, copy=True))
        old = scope.find_var(k)
        if isinstance(old, torch.Tensor):
            t = t.to(old.device)
        scope.var(k, t)


def save(program, model_path: str, protocol=4, **configs):
    """reference static save (fluid/io.py save): persist every scope value
    + the program meta."""
    d = os.path.dirname(model_path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(model_path + ".pdparams", "wb") as f:
        pickle.dump(_scope_arrays(global_scope()), f, protocol=protocol)
    with open(model_path + ".pdmodel", "wb") as f:
        pickle.dump({"feed_names": getattr(program, "feed_names", []),
                     "fetch_names": getattr(program, "fetch_names", [])}, f,
                    protocol=protocol)


def load(program, model_path: str, executor=None, var_list=None):
    """reference static load (fluid/io.py load)."""
    set_program_state(program, load_program_state(model_path,
                                                  var_list=var_list))


def serialize_program(feed_vars=None, fetch_vars=None, program=None,
                      **kwargs) -> bytes:
    """reference static/io.py serialize_program."""
    program = program or default_main_program()
    return pickle.dumps({"feed_names": program.feed_names,
                         "fetch_names": program.fetch_names,
                         "text": program.to_string(False)})


def deserialize_program(data: bytes):
    meta = pickle.loads(data)
    prog = Program()
    prog._fetch_names = meta.get("fetch_names", [])
    return prog


def serialize_persistables(feed_vars=None, fetch_vars=None, executor=None,
                           program=None, **kwargs) -> bytes:
    return pickle.dumps(_scope_arrays(global_scope()))


def deserialize_persistables(program, data: bytes, executor=None):
    set_program_state(program, _from_saved(pickle.loads(data)))


def save_to_file(path: str, content: bytes):
    with open(path, "wb") as f:
        f.write(content)


def load_from_file(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def normalize_program(program, feed_vars=None, fetch_vars=None, **kwargs):
    """reference static/io.py normalize_program — prune/dedup for export.
    A traced graph is already pruned; identity."""
    return program


# -- strategies / multi-device shims -----------------------------------------
class BuildStrategy:
    """reference details/build_strategy.h — pass-pipeline knobs, recorded
    only (the graph is executed as traced)."""

    def __init__(self):
        self.enable_inplace = True
        self.fuse_all_reduce_ops = True
        self.fuse_elewise_add_act_ops = True
        self.fuse_bn_act_ops = True
        self.memory_optimize = True
        self.reduce_strategy = None
        self.gradient_scale_strategy = None


class ExecutionStrategy:
    """reference details/execution_strategy.h."""

    def __init__(self):
        self.num_threads = 1
        self.num_iteration_per_drop_scope = 10
        self.use_thread_barrier = False


class ParallelExecutor:
    """reference framework/parallel_executor.cc: wraps a Program; ``run``
    executes it on the card (``use_cuda=True``) or the CPU."""

    def __init__(self, use_cuda=False, loss_name=None, main_program=None,
                 build_strategy=None, exec_strategy=None, **kwargs):
        self._program = main_program or default_main_program()
        self.build_strategy = build_strategy or BuildStrategy()
        self.exec_strategy = exec_strategy or ExecutionStrategy()
        self._exe = Executor(None if use_cuda else "cpu")

    def run(self, fetch_list=None, feed=None, return_numpy=True):
        return self._exe.run(self._program, feed=feed,
                             fetch_list=fetch_list,
                             return_numpy=return_numpy)


class device_guard:
    """reference framework.py device_guard: tensors made inside (by the
    factories) go to ``device`` ("cpu", "gpu", "gpu:0")."""

    def __init__(self, device=None):
        self._device = device
        self._cm = None

    def __enter__(self):
        if self._device:
            dev = self._device.replace("gpu", "cuda")
            self._cm = torch.device(dev)
            self._cm.__enter__()
        return self

    def __exit__(self, *exc):
        if self._cm is not None:
            self._cm.__exit__(*exc)
        return False


def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_layout=True,
          print_tensor_lod=True, print_phase="both"):
    """reference fluid/layers/control_flow.py Print: prints when the
    program runs (a print op of the graph under a trace)."""
    from ..jit.dy2static import convert_print
    convert_print(message or "", input)
    return input


def py_func(func, x, out=None, backward_func=None,
            skip_vars_in_backward_input=None):
    from .nn import py_func as _py_func
    return _py_func(func, x, out=out, backward_func=backward_func,
                    skip_vars_in_backward_input=skip_vars_in_backward_input)


def accuracy(input, label, k=1, correct=None, total=None):
    """Top-k accuracy (reference fluid/layers/metric_op.py accuracy)."""
    idx = torch.topk(torch.as_tensor(input), k, dim=-1).indices
    label = torch.as_tensor(label)
    if label.ndim == 1:
        label = label[:, None]
    hit = torch.any(idx == label.to(idx.device), dim=-1)
    return torch.mean(hit.to(torch.float32))


def auc(input, label, curve="ROC", num_thresholds=200, topk=1,
        slide_steps=1):
    """Batch AUC (reference fluid/layers/metric_op.py auc) over
    ``num_thresholds`` buckets of the positive-class probability."""
    preds = _numpy(torch.as_tensor(input))
    labels = _numpy(torch.as_tensor(label)).reshape(-1)
    p = preds[:, 1] if preds.ndim == 2 and preds.shape[1] == 2 \
        else preds.reshape(-1)
    bins = np.minimum((p * num_thresholds).astype(np.int64),
                      num_thresholds - 1)
    pos = np.bincount(bins[labels != 0], minlength=num_thresholds)
    neg = np.bincount(bins[labels == 0], minlength=num_thresholds)
    tot_pos = tot_neg = area = 0.0
    for i in range(num_thresholds - 1, -1, -1):
        new_pos, new_neg = tot_pos + pos[i], tot_neg + neg[i]
        area += (new_pos + tot_pos) * (new_neg - tot_neg) / 2.0
        tot_pos, tot_neg = new_pos, new_neg
    value = area / (tot_pos * tot_neg) if tot_pos * tot_neg else 0.0
    return torch.tensor(value, dtype=torch.float32)


def cuda_places(device_ids=None):
    """The cards (reference fluid/framework.py cuda_places); without one,
    the CPU, as the reference falls back to its default devices."""
    devs = ([torch.device("cuda", i)
             for i in range(torch.cuda.device_count())]
            if torch.cuda.is_available() else [torch.device("cpu")])
    if device_ids is None:
        return devs
    return [devs[i] for i in device_ids]


def xpu_places(device_ids=None):
    return cuda_places(device_ids)


class WeightNormParamAttr:
    """reference fluid/param_attr.py WeightNormParamAttr — weight-norm
    reparameterization config."""

    def __init__(self, dim=None, name=None, initializer=None,
                 learning_rate=1.0, regularizer=None, trainable=True,
                 do_model_average=False, need_clip=True):
        self.dim = dim
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable


from . import nn  # noqa: F401,E402
from . import amp  # noqa: F401,E402

__all__ += [
    "Variable", "Scope", "global_scope", "scope_guard", "create_global_var",
    "create_parameter", "load_program_state", "set_program_state", "save",
    "load", "serialize_program", "deserialize_program",
    "serialize_persistables", "deserialize_persistables", "save_to_file",
    "load_from_file", "normalize_program", "BuildStrategy",
    "ExecutionStrategy", "ParallelExecutor", "device_guard", "Print",
    "py_func", "accuracy", "auc", "cuda_places", "xpu_places",
    "WeightNormParamAttr", "nn", "default_startup_program",
    "fill_scope_from_numpy",
]
