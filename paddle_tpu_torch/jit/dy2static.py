"""dy2static — Python control flow over traced tensors staged into
``torch.cond`` and ``while_loop``.

Port of ``paddle_tpu/jit/dy2static.py`` (reference:
fluid/dygraph/dygraph_to_static/ast_transformer.py, the IfElse/Loop/
LogicalOp/Print transformer pipeline, and program_translator.py:232
StaticFunction). The AST pass is the reference's, copied and kept; the
converters it calls are retargeted from ``lax`` to PyTorch's higher-order
ops, which ``make_fx`` records as one node with its branches or its body
as subgraphs:

    if cond: ...            ->  _jst.convert_ifelse(cond, true_fn, false_fn)
                                (``torch.ops.higher_order.cond``)
    while cond: ...         ->  _jst.convert_while(cond_fn, body_fn, vars)
                                (``torch.ops.higher_order.while_loop``)
    for i in range(...):    ->  while-form via normalize_range
    a and b / a or b / not  ->  lazy convert_logical_* (tensor-aware,
                                Python semantics preserved otherwise)
    print(x) / assert t     ->  convert_print / convert_assert (an op of
                                the graph, run when the graph runs)

"Traced" means a fake tensor (``FakeTensor``, also under a functional
wrapper as ``torch.export`` makes them) or any tensor while a proxy mode
is active (``make_fx``). Otherwise each converter runs plain Python, so a
converted function behaves as the original eagerly; in particular
``torch.cond`` itself (which goes through dynamo when called outside a
trace) is never called. Unsupported constructs under a tensor-dependent
condition (return/break/continue inside the statement) raise
Dy2StaticError with the original source location — the reference's
error.py diagnostics contract.
"""
from __future__ import annotations

import ast
import functools
import inspect
import sys
import textwrap
import threading
import warnings

import torch
import torch.utils._pytree as pytree
from torch.overrides import TorchFunctionMode

__all__ = ["convert_function", "Dy2StaticError", "UNDEFINED"]


class Dy2StaticError(RuntimeError):
    pass


class _Undefined:
    """Sentinel for variables assigned in only some branches (reference
    dygraph_to_static undefined-var handling)."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "<dy2static undefined>"

    def __bool__(self):
        raise Dy2StaticError(
            "variable is undefined on this control-flow path (assigned in "
            "only one branch of a converted statement)")


UNDEFINED = _Undefined()


def _proxy_mode():
    from torch.fx.experimental.proxy_tensor import get_proxy_mode
    return get_proxy_mode()


def _is_tracer(x):
    """True for a tensor whose value is unknown here: a fake tensor, or
    any tensor while ``make_fx`` traces (the reference's
    ``isinstance(x, jax.core.Tracer)``)."""
    if not isinstance(x, torch.Tensor):
        return False
    from torch._subclasses.fake_tensor import is_fake
    return is_fake(x) or _proxy_mode() is not None


def _loc(filename, lineno):
    return f"{filename}:{lineno}" if lineno else filename


# ---------------------------------------------------------------------------
# runtime converters (called by the transformed code as _jst.*)
# ---------------------------------------------------------------------------
class _Tensor:
    """Marks a tensor leaf in a branch's or body's recorded outputs."""


_SCALAR_DTYPES = {bool: torch.bool, int: torch.int32, float: torch.float32}


def _scalar_tensor(v, device):
    """A Python scalar of a staged carry or branch output as a 0-d tensor:
    int32 for an int and float32 for a float (lax's weak types), so that
    ``s_int32 + i`` keeps its dtype as it does with a Python ``i``."""
    return torch.tensor(v, dtype=_SCALAR_DTYPES[type(v)], device=device)


def _split_leaves(out, device):
    """(tensors, statics, spec) of a branch's outputs: every tensor leaf and
    every Python scalar (as a 0-d tensor, as lax.cond makes it an array)
    goes through the staged op; any other leaf is recorded and must be
    the same object on both paths."""
    leaves, spec = pytree.tree_flatten(out)
    tensors, statics = [], []
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            tensors.append(leaf)
            statics.append(_Tensor)
        elif type(leaf) in _SCALAR_DTYPES:
            tensors.append(_scalar_tensor(leaf, device))
            statics.append(_Tensor)
        else:
            statics.append(leaf)
    return tensors, statics, spec


def _merge_statics(a, b):
    """The value of a non-tensor leaf after the staged op, or raise."""
    if a is b:
        return a
    if a is UNDEFINED or b is UNDEFINED:
        return b if a is UNDEFINED else a
    try:
        if type(a) is type(b) and bool(a == b):
            return a
    except Exception:
        pass
    raise _Mismatch()


class _Mismatch(Exception):
    pass


class _Lifting(threading.local):
    def __init__(self):
        self.maps = []          # the active branches' {id(outer): inner}
        self.discovering = False


_lifting = _Lifting()


def _mapped(t):
    for m in reversed(_lifting.maps):
        t = m.get(id(t), t)
    return t


class _Substitute(TorchFunctionMode):
    """Inside a staged branch or body: every tensor the user's code
    closes over (a parameter, an outer local) is replaced, op by op, by
    the subgraph input it was lifted to."""

    def __init__(self, mapping):
        super().__init__()
        self.mapping = mapping

    def __enter__(self):
        _lifting.maps.append(self.mapping)
        return super().__enter__()

    def __exit__(self, *exc):
        _lifting.maps.pop()
        return super().__exit__(*exc)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        args, kwargs = pytree.tree_map_only(
            torch.Tensor, lambda a: self.mapping.get(id(a), a),
            (args, kwargs or {}))
        if func is torch.Tensor.__getitem__:
            out = _index_by_tensor(*args)
            if out is not None:
                return out
        return func(*args, **kwargs)


def _is_index_tensor(k):
    return isinstance(k, torch.Tensor) and k.ndim == 0 and \
        not k.is_floating_point() and k.dtype != torch.bool


def _index_by_tensor(x, key):
    """``x[key]`` where ``key`` holds 0-d integer tensors (a staged loop's
    counter): each becomes an ``index_select`` on its dim, so the index is
    never read on the host (``x[t]`` would call ``t.item()``, which a
    trace cannot). Returns None for any other key."""
    keys = key if isinstance(key, tuple) else (key,)
    if not any(_is_index_tensor(k) for k in keys) or not all(
            _is_index_tensor(k) or isinstance(k, (int, slice))
            for k in keys):
        return None
    d = 0
    for k in keys:
        if isinstance(k, slice):
            x = x[(slice(None),) * d + (k,)]
            d += 1
        elif isinstance(k, int):
            x = x.select(d, k)
        else:
            n = x.shape[d]
            idx = torch.remainder(k.reshape(1).long(), n)  # negative ok
            x = torch.index_select(x, d, idx).squeeze(d)
    return x


class _Spy(TorchFunctionMode):
    """Records the tensors of the enclosing trace that a branch reads
    without receiving them as operands."""

    def __init__(self, tracer, operands):
        super().__init__()
        self.tracer = tracer
        self.skip = {id(o) for o in operands}
        self.found = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        from torch.fx.experimental.proxy_tensor import get_proxy_slot
        for t in pytree.tree_leaves((args, kwargs or {})):
            if not isinstance(t, torch.Tensor):
                continue
            t = _mapped(t)
            if id(t) in self.skip:
                continue
            if get_proxy_slot(t, self.tracer, None) is not None:
                self.skip.add(id(t))
                self.found.append(t)
        if func is torch.Tensor.__getitem__:
            out = _index_by_tensor(*args)
            if out is not None:
                return out
        return func(*args, **(kwargs or {}))


def _free_tensors(runs, operands):
    """The enclosing trace's tensors that ``fn(*args)`` for each
    ``(fn, args)`` in ``runs`` reads from its closure or returns. Each
    runs once on the fakes with recording off (a nested converted
    statement runs both of its branches, unstaged)."""
    from torch.fx.experimental.proxy_tensor import (
        disable_proxy_modes_tracing, get_proxy_slot)
    tracer = _proxy_mode().tracer
    spy = _Spy(tracer, operands)
    prev = _lifting.discovering
    _lifting.discovering = True
    try:
        with disable_proxy_modes_tracing(), spy:
            for fn, args in runs:
                out = fn(*_copy_containers(tuple(args)))
                for t in pytree.tree_leaves(out):
                    if isinstance(t, torch.Tensor):
                        t = _mapped(t)
                        if id(t) not in spy.skip and get_proxy_slot(
                                t, tracer, None) is not None:
                            spy.skip.add(id(t))
                            spy.found.append(t)
    finally:
        _lifting.discovering = prev
    return spy.found


def _stage_cond(pred, true_fn, false_fn, init):
    """``torch.ops.higher_order.cond`` over the tensors of ``init`` (also
    those inside its lists and dicts) and the tensors the branches close
    over; the other values reach the branches through their closure."""
    from torch._higher_order_ops.cond import cond_op
    leaves, spec = pytree.tree_flatten(list(init))
    tidx = [k for k, v in enumerate(leaves) if isinstance(v, torch.Tensor)]
    ops = tuple(leaves[k] for k in tidx)
    free = _free_tensors([(true_fn, init), (false_fn, init)], ops)
    rec = {}

    def branch(fn, key):
        def run(*t):
            full = list(leaves)
            for j, k in enumerate(tidx):
                full[k] = t[j]
            lifted = {id(o): x for o, x in zip(free, t[len(tidx):])}
            with _Substitute(lifted):
                # fresh containers: a branch may mutate them
                out = tuple(fn(*pytree.tree_unflatten(full, spec)))
            tensors, statics, spec_o = _split_leaves(out, pred.device)
            rec[key] = (statics, spec_o)
            tensors = [lifted.get(id(x), x) for x in tensors]
            # an output that IS an operand must not alias it
            return tuple(x.clone() if any(x is o for o in t) else x
                         for x in tensors)
        return run

    outs = cond_op(pred, branch(true_fn, True), branch(false_fn, False),
                   ops + tuple(free))
    (st_t, spec_t), (st_f, spec_f) = rec[True], rec[False]
    if spec_t != spec_f or len(st_t) != len(st_f) or any(
            (a is _Tensor) != (b is _Tensor) for a, b in zip(st_t, st_f)):
        raise _Mismatch()
    it = iter(outs)
    leaves_o = [next(it) if a is _Tensor else _merge_statics(a, b)
                for a, b in zip(st_t, st_f)]
    return pytree.tree_unflatten(leaves_o, spec_t)


def _as_pred(cond):
    pred = cond.reshape(())
    return pred if pred.dtype == torch.bool else pred != 0


def convert_ifelse(cond, true_fn, false_fn, init, names,
                   filename="<dy2static>", lineno=0, attr_muts=()):
    """Branch fns take the CURRENT values of every assigned name as
    arguments (a branch that reads-then-writes a name would otherwise see
    it as an unbound local — the reference passes branch inputs the same
    way)."""
    if not _is_tracer(cond):
        return (true_fn if cond else false_fn)(*init)
    if attr_muts:
        # e.g. `self.cache.append(x)`: the container lives on an OBJECT
        # attribute — it cannot be threaded through the staged cond like a
        # local name, and tracing both branches would mutate it
        # unconditionally
        raise Dy2StaticError(
            f"{_loc(filename, lineno)}: branch of a tensor-dependent "
            f"`if` mutates attribute container(s) "
            f"{sorted(set(attr_muts))} in place; bind the container to "
            f"a local variable before the `if` (locals thread through "
            f"the staged branches, attributes cannot)")
    pred = _as_pred(cond)
    if _lifting.discovering or _proxy_mode() is None:
        # a nested statement while a branch is probed, or fakes without a
        # trace: both branches run, nothing is staged
        return _select_branches(pred, true_fn, false_fn, init, names,
                                filename, lineno, None)
    try:
        return _stage_cond(pred, true_fn, false_fn, init)
    except Dy2StaticError:
        raise
    except Exception as e:
        # branches whose outputs differ in structure, shape or dtype (or
        # carry non-tensor values that differ): evaluate BOTH branches
        # and select per variable (select computes both sides — only paid
        # when the strict staged cond cannot apply); a genuine error of
        # the user's code raises again from the branch itself
        return _select_branches(pred, true_fn, false_fn, init, names,
                                filename, lineno, e)


def _is_arrayish(v):
    return isinstance(v, (torch.Tensor, int, float, bool))


def _copy_containers(v):
    """Fresh list/dict/set shells (leaves by reference): branch bodies
    may MUTATE containers, and both branches of a tensor `if` are traced
    — without per-branch copies the second branch would see the first
    branch's mutations."""
    if isinstance(v, list):
        return [_copy_containers(x) for x in v]
    if isinstance(v, dict):
        return {k: _copy_containers(x) for k, x in v.items()}
    if isinstance(v, set):
        return set(v)
    if isinstance(v, tuple):
        return tuple(_copy_containers(x) for x in v)
    return v


def _where(cond, a, b):
    dev = next((t.device for t in (a, b) if isinstance(t, torch.Tensor)),
               cond.device)
    a = a if isinstance(a, torch.Tensor) else torch.tensor(a, device=dev)
    b = b if isinstance(b, torch.Tensor) else torch.tensor(b, device=dev)
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.where(cond, a.to(dt), b.to(dt))


def _select_branches(cond, true_fn, false_fn, init, names, filename,
                     lineno, orig_err):
    outs_t = true_fn(*_copy_containers(tuple(init)))
    outs_f = false_fn(*_copy_containers(tuple(init)))
    res = []
    for n, a, b in zip(names, outs_t, outs_f):
        if a is b:
            res.append(a)
            continue
        if a is UNDEFINED or b is UNDEFINED:
            # assigned on one path only: reading it on the other path is
            # undefined behavior in Python — like the reference's
            # RETURN_NO_VALUE handling, the defined side's value is kept
            # so the trace proceeds (the variable simply should not be
            # consumed when the other branch was taken)
            res.append(b if a is UNDEFINED else a)
            continue
        if _is_arrayish(a) and _is_arrayish(b):
            try:
                res.append(_where(cond, a, b))
                continue
            except Exception:
                raise Dy2StaticError(
                    f"{_loc(filename, lineno)}: variable {n!r} has "
                    f"incompatible shape/dtype across tensor-dependent "
                    f"`if` branches") from orig_err
        try:
            same = type(a) is type(b) and bool(a == b)
        except Exception:  # tensor-holding containers
            same = False
        if same:
            res.append(a)
            continue
        raise Dy2StaticError(
            f"{_loc(filename, lineno)}: variable {n!r} takes different "
            f"non-tensor values per branch of a tensor-dependent `if` — "
            f"this cannot be staged") from orig_err
    return tuple(res)


_UNROLL_CAP = 512


def _meta(v):
    if isinstance(v, torch.Tensor):
        return ("t", tuple(v.shape), v.dtype)
    if type(v) in _SCALAR_DTYPES:
        return ("t", (), _SCALAR_DTYPES[type(v)])
    return ("o", id(v))


def _carry_compatible(a, b):
    """Can a staged while_loop carry go from `a` to `b`? Same pytree
    structure AND same per-leaf shape/dtype."""
    la, sa = pytree.tree_flatten(a)
    lb, sb = pytree.tree_flatten(b)
    if sa != sb:
        return False
    for x, y in zip(la, lb):
        mx, my = _meta(x), _meta(y)
        if mx[0] == "o" or my[0] == "o":
            if x is not y:
                return False
        elif mx != my:
            return False
    return True


def _carry_device(vals):
    for v in pytree.tree_leaves(vals):
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device("cpu")


def _stage_while(cond_fn, body_fn, start_vars):
    """``torch.ops.higher_order.while_loop`` from start_vars -> (True,
    result) or, for a carry that cannot be staged or changes structure,
    (False, the error). Python scalars in the carry become 0-d tensors
    (as lax.while_loop makes them arrays); other non-tensor leaves ride
    in the closure and must come back unchanged."""
    from torch._higher_order_ops.while_loop import while_loop_op
    device = _carry_device(start_vars)
    leaves, spec = pytree.tree_flatten(tuple(start_vars))
    pos = [i for i, v in enumerate(leaves)
           if isinstance(v, torch.Tensor) or type(v) in _SCALAR_DTYPES]
    carried = tuple(v if isinstance(v, torch.Tensor)
                    else _scalar_tensor(v, device)
                    for v in (leaves[i] for i in pos))

    def rebuild(t):
        full = list(leaves)
        for j, i in enumerate(pos):
            full[i] = t[j]
        return pytree.tree_unflatten(full, spec)

    free = _free_tensors([(cond_fn, start_vars), (body_fn, start_vars)],
                         carried)
    n = len(carried)

    def lifted(t):
        return _Substitute({id(o): x for o, x in zip(free, t[n:])})

    def cond_f(*t):
        with lifted(t):
            c = cond_fn(*rebuild(t[:n]))
        return _as_pred(c if isinstance(c, torch.Tensor)
                        else _scalar_tensor(bool(c), device))

    def body_f(*t):
        sub = lifted(t)
        with sub:
            out = tuple(body_fn(*rebuild(t[:n])))
        out_leaves, out_spec = pytree.tree_flatten(out)
        if out_spec != spec:
            raise _Mismatch("loop variables change structure")
        for i, v in enumerate(out_leaves):
            if i not in pos and v is not leaves[i]:
                raise _Mismatch(f"non-tensor loop variable changes: {v!r}")
        res = []
        for j, i in enumerate(pos):
            v = out_leaves[i]
            v = v if isinstance(v, torch.Tensor) else \
                _scalar_tensor(v, device)
            v = sub.mapping.get(id(v), v)
            ref = carried[j]
            if tuple(v.shape) != tuple(ref.shape) or v.dtype != ref.dtype:
                raise _Mismatch(
                    f"loop variable {j} goes from {tuple(ref.shape)} "
                    f"{ref.dtype} to {tuple(v.shape)} {v.dtype}")
            res.append(v.clone() if any(v is x for x in t) else v)
        return tuple(res)

    try:
        out = while_loop_op(cond_f, body_f, carried, tuple(free))
    except Dy2StaticError:
        raise
    except Exception as e:
        if not _is_structure_error(e):
            raise
        return False, e
    return True, tuple(rebuild(tuple(out)))


_STRUCTURE_ERR_HINTS = ("loop variable", "change", "same metadata",
                        "metadata", "mismatch", "structure", "shape",
                        "dtype", "carried", "body_fn", "cond_fn",
                        "Expected", "expected", "must be", "Unsupported")


def _is_structure_error(e) -> bool:
    if isinstance(e, _Mismatch):
        return True
    msg = str(e)
    return any(h in msg for h in _STRUCTURE_ERR_HINTS)


def convert_while(cond_fn, body_fn, init, names, filename="<dy2static>",
                  lineno=0):
    first = cond_fn(*init)
    if _lifting.discovering or _proxy_mode() is None:
        if not _is_tracer(first) and not any(_is_tracer(v) for v in init):
            vars_ = tuple(init)
            while cond_fn(*vars_):
                vars_ = tuple(body_fn(*vars_))
            return vars_
        # probing a branch (or fakes without a trace): one pass of the
        # body shows what it reads; nothing is staged
        if not _is_tracer(first) and not first:
            return tuple(init)
        return tuple(body_fn(*_copy_containers(tuple(init))))
    if not _is_tracer(first) and not any(_is_tracer(v) for v in init):
        vars_ = tuple(init)
        while cond_fn(*vars_):
            vars_ = tuple(body_fn(*vars_))
        return vars_

    if _is_tracer(first):
        # tensor-dependent trip count: only the staged form exists
        if any(v is UNDEFINED for v in init):
            init = _seed_loop_locals(cond_fn, body_fn, init, names,
                                     filename, lineno)
        ok, res = _stage_while(cond_fn, body_fn, init)
        if ok:
            return res
        raise Dy2StaticError(
            f"{_loc(filename, lineno)}: tensor-dependent `while` body "
            f"must keep every loop variable {list(names)} at a fixed "
            f"shape/dtype across iterations: {res}") from res
    # STATIC condition with traced carries. PEEL the first iteration —
    # running the body exactly once decides staged-vs-unrolled without a
    # throwaway trace (an aborted staged attempt would already have
    # executed the body once, replaying its Python-side effects in
    # whichever path ran next).
    if not first:
        return tuple(init)
    # snapshot the pre-body structure: the body may mutate carried
    # containers IN PLACE (acc.append), in which case init aliases the
    # body's output and a post-hoc comparison would see the list equal
    # to itself
    before = _copy_containers(tuple(init))
    try:
        vars_ = tuple(body_fn(*init))
    except Dy2StaticError:
        raise
    except Exception as e:
        undef = [n for n, v in zip(names, init) if v is UNDEFINED]
        if undef:  # the located diagnostic, not a raw _Undefined TypeError
            raise Dy2StaticError(
                f"{_loc(filename, lineno)}: loop variable {undef[0]!r} "
                "is not defined before this loop and is read before "
                "assignment in the body") from e
        raise
    if _carry_compatible(vars_, before):
        # structure-stable: stage the REMAINING iterations compactly
        ok, res = _stage_while(cond_fn, body_fn, vars_)
        if ok:
            return res
        # stable iter0->iter1 but the staged trace failed later (the
        # structure evolves from iteration 2 on): that aborted trace
        # already re-ran the body's Python-side effects once, so
        # unrolling from here would silently diverge from eager — refuse
        raise Dy2StaticError(
            f"{_loc(filename, lineno)}: `while` loop variables change "
            f"structure after the first iteration ({res}); keep them at "
            f"fixed shapes across ALL iterations (preallocate and "
            f"index-update instead of appending)") from res
    # shape/structure-evolving carries with a static trip count (e.g. a
    # decoder appending per-step logits — the reference stages these via
    # TensorArray, test_seq2seq.py): unroll under the trace.
    n = 1
    cond = cond_fn(*vars_)
    while True:
        if _is_tracer(cond):
            # checked BEFORE `while cond` would bool() the fake
            raise Dy2StaticError(
                f"{_loc(filename, lineno)}: `while` condition became "
                f"tensor-dependent mid-loop while the body mutates "
                f"loop-variable structure — neither staged nor unrolled "
                f"form exists")
        if not cond:
            break
        n += 1
        if n > _UNROLL_CAP:
            raise Dy2StaticError(
                f"{_loc(filename, lineno)}: static-trip-count `while` "
                f"with structure-evolving loop variables exceeded the "
                f"{_UNROLL_CAP}-iteration unroll cap — the traced graph "
                f"would contain one copy of the body per iteration. "
                f"Keep loop variables at fixed shapes (preallocate and "
                f"index-update instead of appending) so the loop can "
                f"stage as one while_loop")
        vars_ = tuple(body_fn(*vars_))
        cond = cond_fn(*vars_)
    return vars_


def _seed_loop_locals(cond_fn, body_fn, init, names, filename, lineno):
    """Loop variables first bound INSIDE the body (loop-locals — e.g. the
    induction var of a nested converted loop) have no pre-loop value.
    Probe the body once on the fakes, with the trace's proxy mode off
    (the reference's ``jax.eval_shape``), with UNDEFINED placeholders: a
    variable that is genuinely assigned-before-read comes back with a
    shape/dtype that seeds a zero initial carry (the first iteration
    overwrites it); a variable that is READ first trips on the
    placeholder and gets the diagnostic. Containers are copied so body
    mutations cannot touch the real pre-loop objects.

    Known semantic edge (documented, matches neither Python nor a
    silent crash): after a loop whose runtime trip count is ZERO, a
    seeded loop-local reads as zeros where plain Python would raise
    NameError."""
    from torch.fx.experimental.proxy_tensor import \
        disable_proxy_modes_tracing

    def fail(n, cause=None):
        err = Dy2StaticError(
            f"{_loc(filename, lineno)}: loop variable {n!r} is not "
            "defined before this tensor-dependent loop and is read "
            "before assignment in the body; the staged while_loop needs "
            "an initial value for every variable assigned in the body")
        raise err from cause

    try:
        with disable_proxy_modes_tracing():
            probe = body_fn(*_copy_containers(tuple(init)))
    except Dy2StaticError:
        raise
    except Exception as e:
        undef = [n for n, v in zip(names, init) if v is UNDEFINED]
        fail(undef[0] if undef else "?", e)
    out = list(init)
    for i, (n, v) in enumerate(zip(names, init)):
        if v is not UNDEFINED:
            continue
        p = probe[i]
        if p is UNDEFINED:
            fail(n)
        if isinstance(p, (bool, int, float)):
            p = torch.tensor(p)
        if not isinstance(p, torch.Tensor):
            fail(n)
        out[i] = torch.zeros(tuple(p.shape), dtype=p.dtype, device=p.device)
    return tuple(out)


def init_loop_var(cur, fallback):
    """Give a converted for-loop's target a typed initial carry value
    (the range start) while preserving a pre-existing binding (Python
    keeps the prior value when the range is empty)."""
    return fallback if cur is UNDEFINED else cur


def is_tensor(x):
    """Runtime dispatch for `for v in X`: tensors (fakes included) take
    the staged row-loop, everything else the plain Python loop."""
    return isinstance(x, torch.Tensor)


def tensor_len(x, filename="<dy2static>", lineno=0):
    """Leading-axis length of a tensor — static under trace."""
    if not getattr(x, "shape", ()):
        raise Dy2StaticError(
            f"{_loc(filename, lineno)}: cannot iterate a 0-d tensor in a "
            "converted function")
    return int(x.shape[0])


def row_init(x):
    """Typed pre-loop init for the row variable of a staged
    `for v in tensor` (the while_loop needs an initial value for every
    body-assigned name; the first iteration overwrites it)."""
    return torch.zeros(tuple(x.shape[1:]), dtype=x.dtype, device=x.device)


def row_at(x, i):
    """x[i] made trace-safe for a 0-row tensor: the staged loop body is
    TRACED even when the (static) trip count is zero, and indexing a
    size-0 axis raises at trace time although the body never runs."""
    if x.shape[0] == 0:
        return torch.zeros(tuple(x.shape[1:]), dtype=x.dtype,
                           device=x.device)
    if isinstance(i, torch.Tensor):
        return torch.index_select(x, 0, i.reshape(1).long()).squeeze(0)
    return x[i]


def normalize_range(*args):
    if len(args) == 1:
        return 0, args[0], 1
    if len(args) == 2:
        return args[0], args[1], 1
    return args[0], args[1], args[2]


def range_cond(i, stop, step):
    if _is_tracer(step):
        return torch.where(step > 0, i < stop, i > stop)
    return (i < stop) if step > 0 else (i > stop)


def _bool_tensor(v, like):
    return v if isinstance(v, torch.Tensor) else \
        torch.tensor(bool(v), device=like.device)


def convert_logical_and(lhs, rhs_fn):
    if _is_tracer(lhs):
        return torch.logical_and(lhs, _bool_tensor(rhs_fn(), lhs))
    return lhs and rhs_fn()


def convert_logical_or(lhs, rhs_fn):
    if _is_tracer(lhs):
        return torch.logical_or(lhs, _bool_tensor(rhs_fn(), lhs))
    return lhs or rhs_fn()


def convert_logical_not(x):
    if _is_tracer(x):
        return torch.logical_not(x)
    return not x


# the graph ops behind a traced print/assert: each runs when the staged
# graph runs (the reference's jax.debug.print / jax.debug.callback)
@torch.library.custom_op("paddle_tpu_torch::dy2static_print",
                         mutates_args=())
def _print_op(xs: list[torch.Tensor], fmt: str) -> None:
    print(fmt.format(*[x.detach().cpu() for x in xs]))


@_print_op.register_fake
def _(xs, fmt):
    return None


@torch.library.custom_op("paddle_tpu_torch::dy2static_assert",
                         mutates_args=())
def _assert_op(ok: torch.Tensor, msg: str) -> None:
    if not bool(ok.all()):
        raise AssertionError(msg)


@_assert_op.register_fake
def _(ok, msg):
    return None


def convert_print(*args, **kwargs):
    if any(_is_tracer(a) for a in args):
        parts, tensors = [], []
        for a in args:
            if isinstance(a, torch.Tensor):
                parts.append("{}")
                tensors.append(a)
            else:
                parts.append(str(a).replace("{", "{{").replace("}", "}}"))
        _print_op(tensors, kwargs.get("sep", " ").join(parts))
        return None
    return print(*args, **kwargs)


def convert_assert(test, msg_fn, filename="<dy2static>", lineno=0):
    """`assert` conversion (reference: convert_operators.convert_assert
    -> Assert op). A tensor condition becomes an op of the graph that
    raises when violated — checked at RUN time like the reference's graph
    Assert, not silently dropped at trace time. ``msg_fn`` is a thunk:
    Python only evaluates an assert message on FAILURE (the message
    expression may be invalid on the passing path)."""
    if not _is_tracer(test):
        if not test:
            msg = msg_fn() if msg_fn is not None else None
            raise AssertionError(msg if msg is not None else
                                 f"{_loc(filename, lineno)}: assertion "
                                 f"failed")
        return
    # the message must be evaluated NOW if it is ever to appear (the op
    # outlives the trace); failures inside the thunk fall back to the
    # bare location
    try:
        msg = msg_fn() if msg_fn is not None else None
    except Exception:
        msg = None
    _assert_op(test, f"{_loc(filename, lineno)}: traced assertion failed"
               + (f": {msg}" if msg is not None else ""))


_CALL_SKIP_MODULES = ("builtins", "torch", "numpy", "paddle_tpu_torch",
                      "functools", "itertools", "operator", "math",
                      "typing", "abc", "collections", "copy", "warnings")
# bounded LRU: a nested `def` creates a fresh function object per call
# of its parent, so an unbounded cache would pin every instance (plus
# its closure snapshot — weak keys don't work either: the converted
# function's __wrapped__ back-reference would keep the key alive)
from collections import OrderedDict as _OrderedDict  # noqa: E402

_converted_cache: "_OrderedDict" = _OrderedDict()
_CACHE_CAP = 256


def convert_call(fn):
    """Recursive conversion of user callees (reference:
    convert_call_func.py convert_call): plain user functions/methods get
    the same AST pass (cached), library/builtin callables pass through
    untouched, so control flow inside helpers called from a converted
    function stages too."""
    if not callable(fn) or isinstance(fn, type):
        return fn
    inner = fn.__func__ if inspect.ismethod(fn) else fn
    if not inspect.isfunction(inner):
        return fn  # builtins, callables, layers: leave as-is
    if getattr(inner, "_dy2s_converted", False) or \
            getattr(inner, "_dy2s_is_conversion", False):
        return fn
    module = getattr(inner, "__module__", "") or ""
    if module.split(".")[0] in _CALL_SKIP_MODULES:
        return fn
    key = id(inner)
    cached = _converted_cache.get(key)
    if cached is not None and cached[0] is inner:
        _converted_cache.move_to_end(key)
        conv = cached[1]
    else:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # quiet fallback for callees
            conv = convert_function(inner)
        _converted_cache[key] = (inner, conv)
        _converted_cache.move_to_end(key)
        while len(_converted_cache) > _CACHE_CAP:
            _converted_cache.popitem(last=False)
    if inspect.ismethod(fn):
        return functools.partial(conv, fn.__self__)
    return conv


def assert_python_value(value, construct, filename="<dy2static>", lineno=0):
    """Guard for statements left in Python form because they contain
    constructs a staged op cannot hold (return/break/continue, or a
    for-loop that reassigns its own loop variable)."""
    if _is_tracer(value):
        raise Dy2StaticError(
            f"{_loc(filename, lineno)}: this `{construct}` contains "
            "return/break/continue (or reassigns its loop variable), which "
            "cannot be staged into a converted control-flow op, but "
            "its condition depends on a traced tensor. Restructure to "
            "avoid early exits (accumulate a result and return after the "
            "statement), or hoist the decision out of the staged function.")
    return value


# ---------------------------------------------------------------------------
# AST transformation
# ---------------------------------------------------------------------------
_JST = "__jst__"


def _assigned_names(stmts):
    """Names bound in the statement list — Store names, import aliases,
    nested def/class names — excluding nested function/class BODIES and
    comprehensions (their own scope in py3)."""
    names = []

    def add(n):
        if n not in names:
            names.append(n)

    class V(ast.NodeVisitor):
        def visit_FunctionDef(self, node):
            if not node.name.startswith("__dy2s_"):
                add(node.name)  # the binding, not the body's scope

        visit_AsyncFunctionDef = visit_FunctionDef

        def visit_ClassDef(self, node):
            add(node.name)

        def visit_Lambda(self, node):
            pass

        visit_ListComp = visit_Lambda
        visit_SetComp = visit_Lambda
        visit_DictComp = visit_Lambda
        visit_GeneratorExp = visit_Lambda

        def visit_Import(self, node):
            for a in node.names:
                add(a.asname or a.name.split(".")[0])

        def visit_ImportFrom(self, node):
            for a in node.names:
                add(a.asname or a.name)

        def visit_Name(self, node):
            # __dy2s_* are this pass's own temporaries (inner converted
            # loops' induction/cond/body names): capturing them as branch
            # variables of an ENCLOSING converted statement would demand
            # they match across branches, which they never do
            if isinstance(node.ctx, ast.Store) and \
                    not node.id.startswith("__dy2s_"):
                add(node.id)

    v = V()
    for s in stmts:
        v.visit(s)
    return names


_MUTATOR_METHODS = {"append", "extend", "insert", "pop", "popitem",
                    "remove", "clear", "update", "setdefault", "add",
                    "discard", "sort", "reverse"}


def _mutated_names(stmts):
    """Names whose CONTENTS a statement list may mutate in place —
    container method calls (x.append(...)) and subscript stores
    (x[i] = ..., del x[i]). These carry no ast.Store, but a tensor-`if`
    branch mutating them must thread them through convert_ifelse like
    any assigned name, or the mutation leaks branch-local tracers."""
    names = []

    def add(n):
        if n not in names and not n.startswith("__dy2s_"):
            names.append(n)

    class V(ast.NodeVisitor):
        def visit_FunctionDef(self, node):
            pass  # own scope

        visit_AsyncFunctionDef = visit_FunctionDef
        visit_ClassDef = visit_FunctionDef
        visit_Lambda = visit_FunctionDef

        def visit_Call(self, node):
            f = node.func
            if isinstance(f, ast.Attribute) and \
                    isinstance(f.value, ast.Name) and \
                    f.attr in _MUTATOR_METHODS:
                add(f.value.id)
            self.generic_visit(node)

        def _sub_target(self, t):
            if isinstance(t, ast.Subscript) and \
                    isinstance(t.value, ast.Name):
                add(t.value.id)

        def visit_Assign(self, node):
            for t in node.targets:
                self._sub_target(t)
                if isinstance(t, ast.Tuple):
                    for e in t.elts:
                        self._sub_target(e)
            self.generic_visit(node)

        def visit_AugAssign(self, node):
            self._sub_target(node.target)
            self.generic_visit(node)

        def visit_Delete(self, node):
            for t in node.targets:
                self._sub_target(t)
            self.generic_visit(node)

    v = V()
    for s in stmts:
        v.visit(s)
    return names


def _attr_mutations(stmts):
    """Dotted display names of ATTRIBUTE-held containers a statement
    list mutates in place (obj.attr.append(...), obj.attr[i] = ...).
    These cannot be threaded through staged branches like local names —
    convert_ifelse raises a located diagnostic when the condition is a
    tensor (they would otherwise mutate unconditionally at trace time)."""
    out = []

    def add(node):
        try:
            s = ast.unparse(node)
        except Exception:  # pragma: no cover
            s = "<attribute>"
        if s not in out:
            out.append(s)

    class V(ast.NodeVisitor):
        def visit_FunctionDef(self, node):
            pass

        visit_AsyncFunctionDef = visit_FunctionDef
        visit_ClassDef = visit_FunctionDef
        visit_Lambda = visit_FunctionDef

        def visit_Call(self, node):
            f = node.func
            if isinstance(f, ast.Attribute) and \
                    isinstance(f.value, ast.Attribute) and \
                    f.attr in _MUTATOR_METHODS:
                add(f.value)
            self.generic_visit(node)

        def _sub_target(self, t):
            if isinstance(t, ast.Subscript) and \
                    isinstance(t.value, ast.Attribute):
                add(t.value)

        def visit_Assign(self, node):
            for t in node.targets:
                self._sub_target(t)
            self.generic_visit(node)

        def visit_AugAssign(self, node):
            self._sub_target(node.target)
            self.generic_visit(node)

        def visit_Delete(self, node):
            for t in node.targets:
                self._sub_target(t)
            self.generic_visit(node)

    v = V()
    for s in stmts:
        v.visit(s)
    return out


def _loaded_names(node):
    out = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load):
            out.add(n.id)
    return out


def _has_exits(stmts):
    """Exits that would escape THIS statement: returns anywhere (except
    nested defs), break/continue not owned by a nested loop."""
    found = []

    class Returns(ast.NodeVisitor):
        def visit_FunctionDef(self, node):
            pass

        visit_AsyncFunctionDef = visit_FunctionDef
        visit_Lambda = visit_FunctionDef

        def visit_Return(self, node):
            found.append("return")

    class V(Returns):
        def visit_While(self, node):
            # a nested loop owns break/continue in its BODY; its else
            # clause's break/continue (and all returns) escape to us
            r = Returns()
            for s in node.body:
                r.visit(s)
            for s in node.orelse:
                self.visit(s)

        visit_For = visit_While

        def visit_Break(self, node):
            found.append("break")

        def visit_Continue(self, node):
            found.append("continue")

    v = V()
    for s in stmts:
        v.visit(s)
    return found


def _rewrite_exits(stmts, brk, cont):
    """Lower this loop's OWN break/continue into flag assignments
    (``brk``/``cont`` = True); statements following a possibly-flagging
    If are wrapped in ``if not (brk or cont): ...`` so the rest of the
    iteration is skipped. Nested loops own their exits and are left
    alone; code after a bare break/continue is unreachable and dropped.
    Returns the new statement list."""
    def flag_set(name):
        return ast.Assign(targets=[_name(name, ast.Store())],
                          value=_const(True))

    def skip_guard(rest):
        test = ast.UnaryOp(
            op=ast.Not(),
            operand=ast.BoolOp(op=ast.Or(),
                               values=[_name(brk), _name(cont)]))
        return ast.If(test=test, body=rest, orelse=[])

    out = []
    for i, s in enumerate(stmts):
        if isinstance(s, ast.Break):
            out.append(ast.copy_location(flag_set(brk), s))
            return out                      # rest of block unreachable
        if isinstance(s, ast.Continue):
            out.append(ast.copy_location(flag_set(cont), s))
            return out
        if isinstance(s, ast.If):
            body = _rewrite_exits(s.body, brk, cont)
            orelse = _rewrite_exits(s.orelse, brk, cont)
            flagged = (body != s.body or orelse != s.orelse)
            s = ast.copy_location(
                ast.If(test=s.test, body=body or [ast.Pass()],
                       orelse=orelse), s)
            ast.fix_missing_locations(s)
            out.append(s)
            rest = stmts[i + 1:]
            if flagged and rest:
                g = skip_guard(_rewrite_exits(rest, brk, cont))
                ast.copy_location(g, s)
                ast.fix_missing_locations(g)
                out.append(g)
                return out
            continue
        out.append(s)
    return out


def _name(id_, ctx=None):
    return ast.Name(id=id_, ctx=ctx or ast.Load())


def _jst_attr(attr):
    return ast.Attribute(value=_name(_JST), attr=attr, ctx=ast.Load())


def _call(fn_attr, args, keywords=None):
    return ast.Call(func=_jst_attr(fn_attr), args=args,
                    keywords=keywords or [])


def _const(v):
    return ast.Constant(value=v)


def _undef_guard(name):
    # vN = locals().get("vN", __jst__.UNDEFINED)
    return ast.Assign(
        targets=[_name(name, ast.Store())],
        value=ast.Call(
            func=ast.Attribute(
                value=ast.Call(func=_name("locals"), args=[], keywords=[]),
                attr="get", ctx=ast.Load()),
            args=[_const(name), _jst_attr("UNDEFINED")], keywords=[]))


def _tuple_of(names, ctx=None):
    return ast.Tuple(elts=[_name(n, ctx or ast.Load()) for n in names],
                     ctx=ctx or ast.Load())


def _fn_def(name, argnames, body):
    return ast.FunctionDef(
        name=name,
        args=ast.arguments(posonlyargs=[], args=[ast.arg(arg=a)
                                                 for a in argnames],
                           kwonlyargs=[], kw_defaults=[], defaults=[]),
        body=body, decorator_list=[], returns=None, type_params=[])


class _Transformer(ast.NodeTransformer):
    def __init__(self, filename):
        self.filename = filename
        self.counter = 0

    def _n(self, base):
        self.counter += 1
        return f"__dy2s_{base}_{self.counter}"

    # -- boolean ops (lazy, tensor-aware) ----------------------------------
    def visit_BoolOp(self, node):
        self.generic_visit(node)
        conv = ("convert_logical_and" if isinstance(node.op, ast.And)
                else "convert_logical_or")
        out = node.values[-1]
        for lhs in reversed(node.values[:-1]):
            out = _call(conv, [lhs, ast.Lambda(
                args=ast.arguments(posonlyargs=[], args=[], kwonlyargs=[],
                                   kw_defaults=[], defaults=[]),
                body=out)])
        return ast.copy_location(out, node)

    def visit_UnaryOp(self, node):
        self.generic_visit(node)
        if isinstance(node.op, ast.Not):
            return ast.copy_location(
                _call("convert_logical_not", [node.operand]), node)
        return node

    # calls whose semantics depend on the calling frame or that the
    # converters/builtins already handle — never rerouted
    _CALL_SKIP_NAMES = {"locals", "globals", "vars", "super", "eval",
                        "exec", "print", "range", "enumerate", "zip",
                        "len", "isinstance", "issubclass", "getattr",
                        "setattr", "hasattr", "type", "id", "iter",
                        "next", "min", "max", "abs", "sum", "sorted",
                        "list", "tuple", "dict", "set", "int", "float",
                        "bool", "str", "repr", "format", "breakpoint"}

    def visit_Call(self, node):
        self.generic_visit(node)
        if isinstance(node.func, ast.Name) and node.func.id == "print" \
                and not node.keywords:
            return ast.copy_location(
                _call("convert_print", node.args), node)
        # recursive callee conversion (reference convert_call): wrap the
        # callable so user helpers with control flow stage too
        f = node.func
        skip = (isinstance(f, ast.Name)
                and (f.id in self._CALL_SKIP_NAMES
                     or f.id.startswith(("__dy2s_", "_dy2s_")))) or \
            (isinstance(f, ast.Attribute)
             and isinstance(f.value, ast.Name)
             and f.value.id == _JST)
        if not skip:
            node.func = ast.copy_location(
                _call("convert_call", [f]), f)
        return node

    def visit_Assert(self, node):
        self.generic_visit(node)
        # message as a thunk: Python evaluates it only on failure
        msg = (_const(None) if node.msg is None else ast.Lambda(
            args=ast.arguments(posonlyargs=[], args=[], kwonlyargs=[],
                               kw_defaults=[], defaults=[]),
            body=node.msg))
        return ast.copy_location(ast.Expr(value=_call(
            "convert_assert",
            [node.test, msg, _const(self.filename),
             _const(node.lineno)])), node)

    # -- if / while / for ---------------------------------------------------
    def visit_If(self, node):
        # mutation patterns (x.append / x[i]=) must be read off the RAW
        # body: generic_visit reroutes calls through convert_call and
        # hides them
        mutated = (_mutated_names(node.body) +
                   _mutated_names(node.orelse))
        attr_muts = (_attr_mutations(node.body) +
                     _attr_mutations(node.orelse))
        self.generic_visit(node)
        exits = _has_exits(node.body) + _has_exits(node.orelse)
        if exits:
            # leave in Python form, but fail loudly (with location) if the
            # condition turns out to be a tracer
            node.test = ast.copy_location(
                _call("assert_python_value",
                      [node.test, _const("if"), _const(self.filename),
                       _const(node.lineno)]), node.test)
            return node
        names = sorted(set(_assigned_names(node.body) +
                           _assigned_names(node.orelse) + mutated))
        tf, ff = self._n("true_fn"), self._n("false_fn")
        ret = ast.Return(value=_tuple_of(names))
        stmts = [_undef_guard(n) for n in names]
        stmts.append(_fn_def(tf, names, list(node.body) + [ret]))
        stmts.append(_fn_def(ff, names, (list(node.orelse) or [ast.Pass()])
                             + [ret]))
        assign = ast.Assign(
            targets=[_tuple_of(names, ast.Store())] if names else
                    [_name(self._n("void"), ast.Store())],
            value=_call("convert_ifelse",
                        [node.test, _name(tf), _name(ff), _tuple_of(names),
                         ast.Tuple(elts=[_const(n) for n in names],
                                   ctx=ast.Load()),
                         _const(self.filename), _const(node.lineno),
                         ast.Tuple(elts=[_const(a) for a in attr_muts],
                                   ctx=ast.Load())]))
        stmts.append(assign)
        return [ast.copy_location(ast.fix_missing_locations(s), node)
                for s in stmts]

    def _while_form(self, node, test_expr, body_stmts, extra_loop_names=()):
        names = sorted(set(_assigned_names(body_stmts))
                       | set(extra_loop_names)
                       | (_loaded_names(test_expr)
                          & set(_assigned_names(body_stmts))))
        cf, bf = self._n("while_cond"), self._n("while_body")
        stmts = [_undef_guard(n) for n in names]
        stmts.append(_fn_def(cf, names, [ast.Return(value=test_expr)]))
        stmts.append(_fn_def(
            bf, names, list(body_stmts) + [ast.Return(value=_tuple_of(names))]))
        assign = ast.Assign(
            targets=[_tuple_of(names, ast.Store())] if names else
                    [_name(self._n("void"), ast.Store())],
            value=_call("convert_while",
                        [_name(cf), _name(bf), _tuple_of(names),
                         ast.Tuple(elts=[_const(n) for n in names],
                                   ctx=ast.Load()),
                         _const(self.filename), _const(node.lineno)]))
        stmts.append(assign)
        return [ast.copy_location(ast.fix_missing_locations(s), node)
                for s in stmts]

    def _lower_loop_exits(self, node):
        """Try to lower break/continue in a raw (pre-visit) loop body into
        flag form. Returns (new_body, new_test_wrapper, setup_stmts) or
        None when lowering doesn't apply (returns present, or exits
        hiding where the rewriter can't reach, e.g. under with/try)."""
        exits = _has_exits(node.body)
        if not exits:
            return None
        if "return" in exits:
            return None
        # single-underscore prefix: unlike __dy2s_* temporaries, the flags
        # MUST be visible to _assigned_names so convert_ifelse branches
        # and the while state thread them through
        self.counter += 1
        brk = f"_dy2s_brk_{self.counter}"
        self.counter += 1
        cont = f"_dy2s_cont_{self.counter}"
        body = _rewrite_exits(list(node.body), brk, cont)
        if _has_exits(body):
            return None
        false_c = _const(False)
        reset_cont = ast.Assign(targets=[_name(cont, ast.Store())],
                                value=false_c)
        init = [ast.Assign(targets=[_name(f, ast.Store())], value=false_c)
                for f in (brk, cont)]
        for s in init + [reset_cont]:
            ast.copy_location(s, node)
            ast.fix_missing_locations(s)

        def wrap_test(test):
            t = ast.BoolOp(op=ast.And(),
                           values=[ast.UnaryOp(op=ast.Not(),
                                               operand=_name(brk)), test])
            ast.copy_location(t, test)
            return ast.fix_missing_locations(t)

        return [reset_cont] + body, wrap_test, init

    def visit_While(self, node):
        if node.orelse:
            self.generic_visit(node)
            return node  # while/else: Python-only construct, leave as-is
        mutated = _mutated_names(node.body)  # raw body (see visit_If)
        setup = []
        lowered = self._lower_loop_exits(node)
        if lowered is not None:
            body, wrap_test, setup = lowered
            node = ast.copy_location(
                ast.While(test=wrap_test(node.test), body=body, orelse=[]),
                node)
            ast.fix_missing_locations(node)
        self.generic_visit(node)
        if _has_exits(node.body):
            node.test = ast.copy_location(
                _call("assert_python_value",
                      [node.test, _const("while"), _const(self.filename),
                       _const(node.lineno)]), node.test)
            return setup + [node] if setup else node
        return setup + self._while_form(node, node.test, node.body,
                                        extra_loop_names=tuple(mutated))

    def _rewrite_tensor_loop(self, node, targets, sources, index=None,
                             mode="iter"):
        """Shared dual-form builder for `for v in X`, `for i, v in
        enumerate(X)` and `for a, b[, c] in zip(X, Y[, Z])`:

            __x_j = SOURCE_j ...
            if is_tensor(__x_0) [and ...]:
                t_j = init_loop_var(prior_or_UNDEFINED, row_init(__x_j))
                [i = init_loop_var(prior, 0)]
                for __row in range(min(tensor_len(__x_j, ...), ...)):
                    [i = __row]; t_j = __x_j[__row] ...; BODY
            else:
                for <original targets> in <original form over __x_j>: BODY

        Both copies are then transformed normally (the Python copy is
        marked to stop re-rewriting). The init_loop_var wrapper keeps a
        pre-existing binding when the leading dim is 0, matching Python's
        empty-loop semantics (same contract as the range path).

        Note: each nested non-range loop doubles its body (tensor +
        Python branch) — 2^k copies at nesting depth k. Acceptable for
        realistic nesting; revisit if it ever bites.
        """
        import copy as _copy
        xs = [self._n("iterable") for _ in sources]
        row = self._n("row")
        assigns = [ast.Assign(targets=[_name(x, ast.Store())], value=src)
                   for x, src in zip(xs, sources)]

        def keep_prior(name, fallback):
            prior = ast.Call(
                func=ast.Attribute(
                    value=ast.Call(func=_name("locals"), args=[],
                                   keywords=[]),
                    attr="get", ctx=ast.Load()),
                args=[_const(name), _jst_attr("UNDEFINED")], keywords=[])
            return ast.Assign(
                targets=[ast.Name(id=name, ctx=ast.Store())],
                value=_call("init_loop_var", [prior, fallback]))

        inits = [keep_prior(t, _call("row_init", [_name(x)]))
                 for t, x in zip(targets, xs)]
        sets = [ast.Assign(
            targets=[ast.Name(id=t, ctx=ast.Store())],
            value=_call("row_at", [_name(x), _name(row)]))
            for t, x in zip(targets, xs)]
        if index is not None:
            inits.insert(0, keep_prior(index, _const(0)))
            sets.insert(0, ast.Assign(
                targets=[ast.Name(id=index, ctx=ast.Store())],
                value=_name(row)))
        lens = [_call("tensor_len", [_name(x), _const(self.filename),
                                     _const(node.lineno)]) for x in xs]
        bound = lens[0] if len(lens) == 1 else ast.Call(
            func=ast.Name(id="min", ctx=ast.Load()), args=lens,
            keywords=[])
        tensor_for = ast.For(
            target=_name(row, ast.Store()),
            iter=ast.Call(func=ast.Name(id="range", ctx=ast.Load()),
                          args=[bound], keywords=[]),
            body=sets + _copy.deepcopy(node.body), orelse=[],
            type_comment=None)
        if mode == "iter":
            py_iter = _name(xs[0])
        else:
            py_iter = ast.Call(func=ast.Name(id=mode, ctx=ast.Load()),
                               args=[_name(x) for x in xs], keywords=[])
        python_for = ast.For(target=node.target, iter=py_iter,
                             body=node.body, orelse=[], type_comment=None)
        python_for._dy2s_plain = True
        test = _call("is_tensor", [_name(xs[0])])
        for x in xs[1:]:
            test = ast.BoolOp(op=ast.And(),
                              values=[test, _call("is_tensor", [_name(x)])])
        dispatch = ast.If(test=test, body=inits + [tensor_for],
                          orelse=[python_for])
        out = []
        for s in assigns + [dispatch]:
            ast.copy_location(s, node)
            ast.fix_missing_locations(s)
            v = self.visit(s)
            out.extend(v if isinstance(v, list) else [v])
        return out

    def visit_For(self, node):
        mutated = _mutated_names(node.body)  # raw body (see visit_If)
        setup_exits = []
        test_wrap = None
        is_range_call = (isinstance(node.iter, ast.Call)
                         and isinstance(node.iter.func, ast.Name)
                         and node.iter.func.id == "range")
        if (isinstance(node.target, ast.Tuple) and not node.orelse
                and len(node.target.elts) == 2
                and all(isinstance(e, ast.Name) for e in node.target.elts)
                and not getattr(node, "_dy2s_plain", False)
                and isinstance(node.iter, ast.Call)
                and isinstance(node.iter.func, ast.Name)
                and node.iter.func.id == "enumerate"
                and len(node.iter.args) == 1 and not node.iter.keywords):
            return self._rewrite_tensor_loop(
                node, targets=[node.target.elts[1].id],
                sources=[node.iter.args[0]],
                index=node.target.elts[0].id, mode="enumerate")
        if (isinstance(node.target, ast.Tuple) and not node.orelse
                and len(node.target.elts) in (2, 3)
                and all(isinstance(e, ast.Name) for e in node.target.elts)
                and not getattr(node, "_dy2s_plain", False)
                and isinstance(node.iter, ast.Call)
                and isinstance(node.iter.func, ast.Name)
                and node.iter.func.id == "zip"
                and len(node.iter.args) == len(node.target.elts)
                and not node.iter.keywords):
            return self._rewrite_tensor_loop(
                node, targets=[e.id for e in node.target.elts],
                sources=list(node.iter.args), mode="zip")
        if (isinstance(node.target, ast.Name) and not node.orelse
                and not is_range_call
                and not getattr(node, "_dy2s_plain", False)
                and not isinstance(node.iter, (ast.List, ast.Tuple,
                                               ast.Dict, ast.Set))):
            return self._rewrite_tensor_loop(
                node, targets=[node.target.id], sources=[node.iter],
                mode="iter")
        if (isinstance(node.target, ast.Name) and not node.orelse
                and isinstance(node.iter, ast.Call)
                and isinstance(node.iter.func, ast.Name)
                and node.iter.func.id == "range"):
            lowered = self._lower_loop_exits(node)
            if lowered is not None:
                body, test_wrap, setup_exits = lowered
                node = ast.copy_location(
                    ast.For(target=node.target, iter=node.iter, body=body,
                            orelse=[], type_comment=None), node)
                ast.fix_missing_locations(node)
        self.generic_visit(node)
        is_range = (isinstance(node.iter, ast.Call)
                    and isinstance(node.iter.func, ast.Name)
                    and node.iter.func.id == "range"
                    and not node.iter.keywords
                    and isinstance(node.target, ast.Name)
                    # a body that reassigns the loop variable would corrupt
                    # the while-form induction (Python's range reassigns it
                    # fresh each iteration): leave such loops in Python
                    and node.target.id not in _assigned_names(node.body))
        if not is_range or node.orelse or _has_exits(node.body):
            if isinstance(node.iter, ast.Call) and \
                    isinstance(node.iter.func, ast.Name) and \
                    node.iter.func.id == "range" and not node.iter.keywords:
                node.iter.args = [ast.copy_location(
                    _call("assert_python_value",
                          [a, _const("for"), _const(self.filename),
                           _const(node.lineno)]), a)
                    for a in node.iter.args]
            if setup_exits:
                # lowered flag form still runs correctly in Python, but it
                # needs its not-yet-staged test guard: reinstate a plain
                # break on the flag at body top
                node.body.insert(0, ast.copy_location(
                    ast.fix_missing_locations(ast.If(
                        test=self.visit(ast.Name(
                            id=setup_exits[0].targets[0].id,
                            ctx=ast.Load())),
                        body=[ast.Break()], orelse=[])), node))
                return setup_exits + [node]
            return node
        t = node.target.id
        start_n, stop_n, step_n, it_n = (self._n("start"), self._n("stop"),
                                         self._n("step"), self._n("it"))
        setup = [
            ast.Assign(
                targets=[ast.Tuple(elts=[_name(start_n, ast.Store()),
                                         _name(stop_n, ast.Store()),
                                         _name(step_n, ast.Store())],
                                   ctx=ast.Store())],
                value=_call("normalize_range", list(node.iter.args))),
            ast.Assign(targets=[_name(it_n, ast.Store())],
                       value=_name(start_n)),
            # typed pre-loop init for the target (keeps a prior binding)
            ast.Assign(
                targets=[_name(t, ast.Store())],
                value=_call("init_loop_var", [
                    ast.Call(
                        func=ast.Attribute(
                            value=ast.Call(func=_name("locals"), args=[],
                                           keywords=[]),
                            attr="get", ctx=ast.Load()),
                        args=[_const(t), _jst_attr("UNDEFINED")],
                        keywords=[]),
                    _name(it_n)])),
        ]
        setup = [ast.copy_location(ast.fix_missing_locations(s), node)
                 for s in setup]
        # hidden induction variable: the USER-visible target is assigned at
        # body start and keeps its last-iteration value after the loop
        # (Python range semantics), instead of leaking the post-increment
        test = _call("range_cond", [_name(it_n), _name(stop_n),
                                    _name(step_n)])
        if test_wrap is not None:
            # break support: test becomes (not brk) and range_cond(...);
            # re-visit so the BoolOp/Not lower to the convert_* helpers
            test = self.visit(ast.fix_missing_locations(
                ast.copy_location(test_wrap(test), node)))
        set_t = ast.Assign(targets=[_name(t, ast.Store())],
                           value=_name(it_n))
        # rebinding, not ``+=``: a tensor's ``+=`` writes in place, and the
        # target variable holds the same tensor
        inc = ast.Assign(targets=[_name(it_n, ast.Store())],
                         value=ast.BinOp(left=_name(it_n), op=ast.Add(),
                                         right=_name(step_n)))
        return setup_exits + setup + self._while_form(
            node, test, [set_t] + list(node.body) + [inc],
            extra_loop_names=(it_n, t) + tuple(mutated))


class _GlobalsProxy(dict):
    """exec namespace that falls through to the function's LIVE module
    globals: names defined later in the module (helpers below the decorated
    function, monkeypatched globals, self-recursion) keep working. CPython
    supports dict subclasses with __missing__ as exec globals."""

    def __init__(self, live, extra):
        super().__init__(extra)
        self._live = live

    def __missing__(self, key):
        return self._live[key]


def convert_function(fn):
    """AST-convert `fn` (reference: program_translator StaticFunction).
    Falls back to the original function (with a warning) when the source
    is unavailable (builtins, REPL lambdas, already-compiled code) or the
    function needs a __class__ cell (zero-arg super())."""
    if "__class__" in fn.__code__.co_freevars:
        warnings.warn(
            f"dy2static: {fn.__qualname__} uses zero-arg super() — the "
            "__class__ cell cannot be rebuilt through recompilation; "
            "running without AST conversion")
        return fn
    try:
        src = textwrap.dedent(inspect.getsource(fn))
        filename = inspect.getsourcefile(fn) or "<dy2static>"
        tree = ast.parse(src)
    except (OSError, TypeError, SyntaxError) as e:
        warnings.warn(f"dy2static: cannot convert {fn!r} ({e}); running "
                      "without AST conversion")
        return fn
    # diagnostics and tracebacks must point at the real file lines
    ast.increment_lineno(tree, fn.__code__.co_firstlineno - 1)
    fdef = tree.body[0]
    if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
        warnings.warn(f"dy2static: {fn!r} is not a plain function; running "
                      "without AST conversion")
        return fn
    if any(isinstance(n, (ast.Global, ast.Nonlocal))
           for n in ast.walk(fdef)):
        # global/nonlocal stores would land in the exec proxy (or a
        # generated branch fn's locals), silently diverging from the
        # original's side effects — decline rather than corrupt
        warnings.warn(
            f"dy2static: {fn.__qualname__} uses global/nonlocal "
            "declarations; running without AST conversion")
        return fn
    fdef.decorator_list = []  # don't re-apply @to_static etc.
    try:
        _Transformer(filename).visit(fdef)
        ast.fix_missing_locations(tree)
        code = compile(tree, filename=filename, mode="exec")
    except Exception as e:  # a transformer defect must degrade, not crash
        warnings.warn(f"dy2static: AST conversion of {fn.__qualname__} "
                      f"failed ({type(e).__name__}: {e}); running without "
                      "conversion")
        return fn
    extra = {_JST: sys.modules[__name__]}
    if fn.__closure__:
        # re-bind free variables by value (cells cannot be carried through
        # recompilation; late rebinding of closed-over names is not
        # supported — the reference has the same snapshot semantics)
        for name, cell in zip(fn.__code__.co_freevars, fn.__closure__):
            try:
                extra[name] = cell.cell_contents
            except ValueError:
                pass
    # the import machinery reads module-context dunders with dict.get
    # (which bypasses __missing__): seed them into the proxy's own storage
    for dunder in ("__name__", "__package__", "__loader__", "__spec__",
                   "__builtins__"):
        if dunder in fn.__globals__:
            extra.setdefault(dunder, fn.__globals__[dunder])
    namespace = _GlobalsProxy(fn.__globals__, extra)
    exec(code, namespace)
    new_fn = namespace[fdef.name]
    new_fn.__defaults__ = fn.__defaults__
    new_fn.__kwdefaults__ = fn.__kwdefaults__
    functools.update_wrapper(new_fn, fn, updated=[])
    new_fn.__wrapped__ = fn
    new_fn._dy2s_converted = True  # convert_call must not re-convert
    return new_fn
