"""dy2static of the PyTorch port against the JAX package.

Every case of the reference's ``tests/test_dy2static.py`` and
``tests/test_dy2static_ported.py`` (themselves ported from the reference
framework's dygraph_to_static suite) is written once, in the Paddle API
that both packages share (``pd.sum``, ``pd.zeros`` ...), and built for
each package by a factory ``make(pd)``. The reference runs
``jax.jit(convert_function(fn))``; the port runs ``jit.to_static(fn)``
(the same AST pass, then a ``make_fx`` graph on fakes, executed). The
outputs must agree within 1e-6 (rtol and atol, float32; integers
exactly), and the port's graph must hold the ``cond`` / ``while_loop``
node the reference stages into ``lax.cond`` / ``lax.while_loop``.
Diagnostics (``Dy2StaticError`` with the source line) are checked in
both packages.
"""
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu.jit.dy2static import Dy2StaticError as RefError
from paddle_tpu.jit.dy2static import convert_function as ref_convert
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.jit.dy2static import Dy2StaticError, convert_function

TOL = dict(rtol=1e-6, atol=1e-6)
X = np.random.RandomState(0).randn(3, 4).astype("float32")


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _leaves(out):
    if isinstance(out, (list, tuple)):
        return [x for o in out for x in _leaves(o)]
    return [out]


def _to_ref(a):
    return jnp.asarray(a) if isinstance(a, np.ndarray) else a


def _to_port(a):
    return torch.from_numpy(a.copy()) if isinstance(a, np.ndarray) else a


def run_ref(make, args, static=()):
    fn = make(ref)
    return jax.jit(ref_convert(fn), static_argnums=static)(
        *[_to_ref(a) for a in args])


def run_port(make, args):
    fn = port.jit.to_static(make(port))
    return fn(*[_to_port(a) for a in args]), fn


def ops_of(graph):
    """Call-node op names of a graph and of its control-flow subgraphs."""
    names = []
    for gm in [graph] + [m for m in graph.modules()
                         if isinstance(m, torch.fx.GraphModule)]:
        for n in gm.graph.nodes:
            if n.op == "call_function":
                names.append(getattr(n.target, "__name__", str(n.target)))
    return names


def assert_same(r, p):
    rl, pl = _leaves(r), _leaves(p)
    assert len(rl) == len(pl)
    for a, b in zip(rl, pl):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape, (a.shape, b.shape)
        if np.issubdtype(a.dtype, np.floating):
            np.testing.assert_allclose(b, a, **TOL)
        else:
            np.testing.assert_array_equal(b, a)


# -- the cases: name -> (make(pd) -> fn, args, static argnums, staged op) ----
def _if(pd):
    def f(x):
        if pd.sum(x) > 0:
            y = x + 1.0
        else:
            y = x - 1.0
        return y
    return f


def _nested_if(pd):
    def f(x):
        s = pd.sum(x)
        if s > 0:
            if s > 10:
                y = x * 3.0
            else:
                y = x * 2.0
        else:
            y = -x
        return y
    return f


def _python_if(pd):
    def f(x, flag=True):
        if flag:
            y = x * 2
        else:
            y = x * 3
        return y
    return f


def _one_branch(pd):
    def f(x):
        if pd.sum(x) > 0:
            y = x + 1
        return y  # noqa: F821
    return f


def _early_return_python(pd):
    def f(x, n):
        if n > 0:
            return x + n
        return x - n
    return f


def _tensor_while(pd):
    def f(x):
        s = pd.zeros([])
        while s < 10.0:
            s = s + pd.sum(x)
        return s
    return f


def _while_multiple_vars(pd):
    def f(x):
        i = pd.zeros([], "int32")
        acc = pd.zeros_like(x)
        while i < 5:
            acc = acc + x * (i + 1)
            i = i + 1
        return acc, i
    return f


def _for_range_tensor_bound(pd):
    def f(x, n):
        acc = pd.zeros_like(x)
        for i in range(n):
            acc = acc + x + i
        return acc
    return f


def _for_range_start_stop_step(pd):
    def f(n):
        s = pd.zeros([], "int32")
        for i in range(2, n, 3):
            s = s + i
        return s
    return f


def _python_loop(pd):
    def f(x, n):
        for _ in range(n):
            x = x * 2
        return x
    return f


def _break_in_while(pd):
    def f(x):
        s = pd.zeros([])
        while s < 10.0:
            s = s + pd.sum(x)
            if s > 5.0:
                break
        return s
    return f


def _break_in_for(pd):
    def f(x):
        found = pd.zeros([])
        for i in range(5):
            if x[i] > 0.5:
                found = x[i]
                break
        return found
    return f


def _continue_in_for(pd):
    def f(x):
        s = pd.zeros([])
        for i in range(5):
            if x[i] < 0:
                continue
            s = s + x[i]
        return s
    return f


def _break_and_continue(pd):
    def f(x):
        s = pd.zeros([])
        for i in range(6):
            if x[i] < 0:
                continue
            if s > 4.0:
                break
            s = s + x[i]
        return s
    return f


def _logical(pd):
    def f(x):
        a = pd.sum(x) > 0
        b = pd.max(x) < 5
        if a and b:
            y = x + 10
        elif a or not b:
            y = x - 10
        else:
            y = x
        return y
    return f


def _inner_python_break(pd):
    def f(x):
        if pd.sum(x) > 0:
            y = x
            for k in [1, 2, 3]:
                if k == 2:
                    break
                y = y + k
        else:
            y = -x
        return y
    return f


def _loop_var_final(pd):
    def f(x, n):
        s = x
        i = -1
        for i in range(n):
            s = s + i
        return s, i
    return f


def _loop_in_tensor_if(pd):
    def f(x):
        if pd.sum(x) > 0:
            s = x
            for i in range(3):
                s = s + i
        else:
            s = -x
        return s
    return f


def _rows(pd):
    def f(x):
        s = pd.zeros([x.shape[1]])
        for row in x:
            s = s + row
        return s
    return f


def _rows_break(pd):
    def f(x):
        s = pd.zeros([])
        for v in x:
            if v > 2.5:
                break
            s = s + v
        return s
    return f


def _enumerate_rows(pd):
    def f(x):
        s = pd.zeros([])
        for i, v in enumerate(x):
            s = s + v * i
        return s
    return f


def _zip_rows(pd):
    def f(x, y):
        s = pd.zeros([])
        for a, b in zip(x, y):
            s = s + a * b
        return s
    return f


def _empty_rows(pd):
    def f(x, empty):
        v = x
        i = pd.full([], 7, "int32")
        for v in empty:
            pass
        for i, v in enumerate(empty):
            pass
        return v, i
    return f


def _append_plain(pd):
    def f(x):
        a = []
        a.append(x)
        a.append(x * 2)
        return a[0] + a[1]
    return f


def _append_in_if(pd):
    def f(x):
        a = [x]
        if x.sum() > 0:
            a.append(x * 2)
        else:
            a.append(x * 3)
        return a[-1]
    return f


def _append_python_for(pd):
    def f(x):
        a = []
        for i in range(3):
            a.append(x * (i + 1))
        return pd.concat(a, axis=0)
    return f


def _pop_in_if(pd):
    def f(x):
        a = [x, x * 2, x * 3]
        if x.sum() > 0:
            b = a.pop()
        else:
            b = a.pop()
        return b + a[-1]
    return f


def _rollout_cache(pd):
    def f(x):
        cache = {"k": pd.zeros_like(x), "v": pd.zeros_like(x)}
        for t in range(4):
            cache["k"] = cache["k"] * 0.5 + x
            cache["v"] = cache["v"] + cache["k"]
        return cache["v"]
    return f


def _dict_pop(pd):
    def f(x):
        d = {"a": x, "b": x * 2}
        v = d.pop("b")
        return v + d["a"]
    return f


def _helper_scale(y):
    if y.sum() > 0:
        out = y * 2
    else:
        out = y * 3
    return out


def _helper_outer(y):
    return _helper_scale(y) + 1


def _nested_function(pd):
    def f(x):
        return _helper_scale(x)
    return f


def _two_levels(pd):
    def f(x):
        return _helper_outer(x)
    return f


def _lambda(pd):
    def f(x):
        g = lambda v: v * 2 + 1  # noqa: E731
        return g(x)
    return f


def _method_callee(pd):
    class Helper:
        def scale(self, y):
            if y.sum() > 0:
                r = y * 4
            else:
                r = y
            return r

    h = Helper()

    def f(x):
        return h.scale(x)
    return f


def _len(pd):
    def f(x):
        n = len(x)
        return x * n
    return f


def _cast(pd):
    def f(x):
        if x.sum() > 0:
            y = pd.cast(x, "int32")
        else:
            y = pd.cast(x, "int32") * 2
        return pd.cast(y, "float32")
    return f


def _isinstance(pd):
    def f(x):
        if isinstance(x, (int, float)):
            return pd.to_tensor(float(x))
        return x * 2
    return f


def _slice_write(pd):
    def f(x):
        out = pd.zeros_like(x)
        for i in range(3):
            idx = pd.ones([1], "int32") * i
            out = pd.scatter(out, idx, pd.gather(x, idx) * (i + 1))
        return out
    return f


def _shape_cond(pd):
    def f(x):
        if x.shape[0] > 2:
            r = x.reshape([-1])
        else:
            r = x
        return r
    return f


def _python_multi_return(pd):
    def f(x, flag):
        if flag:
            return x * 2
        return x
    return f


def _nested_while(pd):
    def f(x):
        i = pd.zeros([], "int32")
        s = pd.zeros([])
        while i < 4:
            j = pd.zeros([], "int32")
            while j < 3:
                s = s + x[0, 0]
                j = j + 1
            i = i + 1
        return s
    return f


def _for_with_if(pd):
    def f(x):
        total = pd.zeros([])
        for i in range(3):
            for j in range(2):
                if x[i, j] > 0:
                    total = total + x[i, j]
        return total
    return f


def _try_except(pd):
    def f(x):
        try:
            if x.sum() > 0:
                y = x * 2
            else:
                y = x
        except ValueError:
            y = x * 0
        return y
    return f


def _box_head(pd):
    def box_head(feat):
        anchors = [(10.0, 13.0), (16.0, 30.0)]
        outs = []
        for a in range(len(anchors)):
            aw, ah = anchors[a]
            raw = feat[:, a * 4:(a + 1) * 4]
            cx = pd.sigmoid(raw[:, 0])
            cy = pd.sigmoid(raw[:, 1])
            bw = pd.exp(pd.clip(raw[:, 2], -5, 5)) * aw
            bh = pd.exp(pd.clip(raw[:, 3], -5, 5)) * ah
            outs.append(pd.stack([cx, cy, bw, bh], axis=1))
        boxes = pd.stack(outs, axis=1)
        if boxes.sum() > 1e9:
            boxes = boxes * 0.0
        return boxes
    return box_head


POS = np.ones((3,), "float32")
ROW5 = np.asarray([0.1, 0.7, 0.9, 0.2, 0.8], "float32")
CASES = {
    # test_dy2static.py
    "tensor_if+": (_if, (POS,), (), "cond"),
    "tensor_if-": (_if, (-POS,), (), "cond"),
    "nested_if_small": (_nested_if, (np.full((4,), 0.1, "float32"),), (),
                        "cond"),
    "nested_if_big": (_nested_if, (np.full((4,), 5.0, "float32"),), (),
                      "cond"),
    "nested_if_neg": (_nested_if, (np.full((4,), -1.0, "float32"),), (),
                      "cond"),
    "python_if_untouched": (_python_if, (np.ones((2,), "float32"),), (),
                            None),
    "one_branch_assignment": (_one_branch, (np.ones((2,), "float32"),), (),
                              None),
    "early_return_python+": (_early_return_python,
                             (np.ones((2,), "float32"), 3), (1,), None),
    "early_return_python-": (_early_return_python,
                             (np.ones((2,), "float32"), -3), (1,), None),
    "tensor_while": (_tensor_while, (POS,), (), "while_loop"),
    "while_multiple_vars": (_while_multiple_vars,
                            (np.arange(3, dtype="float32"),), (),
                            "while_loop"),
    "for_range_tensor_bound": (_for_range_tensor_bound,
                               (np.ones((2,), "float32"),
                                np.asarray(4, "int32")), (), "while_loop"),
    "for_range_step_11": (_for_range_start_stop_step,
                          (np.asarray(11, "int32"),), (), "while_loop"),
    "for_range_step_3": (_for_range_start_stop_step,
                         (np.asarray(3, "int32"),), (), "while_loop"),
    "python_loop_untouched": (_python_loop, (np.ones((), "float32"), 3),
                              (1,), None),
    "break_in_tensor_while": (_break_in_while, (POS,), (), "while_loop"),
    "break_in_for_range": (_break_in_for, (ROW5,), (), "while_loop"),
    "continue_in_for_range": (_continue_in_for,
                              (np.asarray([1, -2, 3, -4, 5], "float32"),),
                              (), "while_loop"),
    "break_and_continue": (_break_and_continue,
                           (np.asarray([1, -1, 2, 3, 10, 20], "float32"),),
                           (), "while_loop"),
    "logical_ops_ones": (_logical, (np.ones((2,), "float32"),), (), "cond"),
    "logical_ops_nines": (_logical, (np.full((2,), 9.0, "float32"),), (),
                          "cond"),
    "logical_ops_neg": (_logical, (-np.ones((2,), "float32"),), (), "cond"),
    "inner_python_break+": (_inner_python_break, (np.ones((2,), "float32"),),
                            (), "where"),
    "inner_python_break-": (_inner_python_break,
                            (-np.ones((2,), "float32"),), (), "where"),
    "for_loop_var_final": (_loop_var_final,
                           (np.zeros((), "float32"), np.asarray(3, "int32")),
                           (), "while_loop"),
    "converted_loop_in_tensor_if+": (_loop_in_tensor_if,
                                     (np.ones((2,), "float32"),), (),
                                     "where"),
    "converted_loop_in_tensor_if-": (_loop_in_tensor_if,
                                     (-np.ones((2,), "float32"),), (),
                                     "where"),
    "for_over_tensor_rows": (_rows, (np.arange(12, dtype="float32")
                                     .reshape(4, 3),), (), "while_loop"),
    "for_over_tensor_with_break": (_rows_break,
                                   (np.asarray([1, 2, 3, 4], "float32"),),
                                   (), "while_loop"),
    "enumerate_over_tensor": (_enumerate_rows,
                              (np.asarray([1, 2, 3, 4], "float32"),), (),
                              "while_loop"),
    "zip_over_tensors": (_zip_rows, (np.asarray([1, 2, 3], "float32"),
                                     np.asarray([4, 5, 6, 7], "float32")),
                         (), "while_loop"),
    "empty_leading_dim": (_empty_rows, (np.ones((3,), "float32"),
                                        np.zeros((0, 3), "float32")), (),
                          None),
    # test_dy2static_ported.py
    "list_append_plain": (_append_plain, (X,), (), None),
    "list_append_in_tensor_if+": (_append_in_if, (np.abs(X) + 0.1,), (),
                                  "cond"),
    "list_append_in_tensor_if-": (_append_in_if, (-np.abs(X) - 0.1,), (),
                                  "cond"),
    "list_append_python_for": (_append_python_for, (X,), (), None),
    "list_pop_in_tensor_if": (_pop_in_if, (X,), (), "cond"),
    "dict_rollout_cache": (_rollout_cache, (X,), (), None),
    "dict_pop": (_dict_pop, (X,), (), None),
    "nested_function+": (_nested_function, (np.abs(X) + 0.1,), (), "cond"),
    "nested_function-": (_nested_function, (-np.abs(X) - 0.1,), (), "cond"),
    "two_levels_deep": (_two_levels, (X,), (), "cond"),
    "lambda": (_lambda, (X,), (), None),
    "method_callee": (_method_callee, (np.abs(X) + 0.1,), (), "cond"),
    "len_of_tensor": (_len, (X,), (), None),
    "cast_in_control_flow": (_cast, (np.abs(X) + 1.0,), (), "cond"),
    "isinstance_dispatch": (_isinstance, (X,), (), None),
    # the loop-local ``idx`` changes the carry's structure after the first
    # pass: both packages unroll (the reference's _carry_compatible)
    "slice_write_in_loop": (_slice_write, (X,), (), None),
    "shape_in_condition": (_shape_cond, (X,), (), None),
    "python_cond_multi_return": (_python_multi_return, (X, True), (1,),
                                 None),
    "nested_tensor_while_local": (_nested_while, (X,), (), "while_loop"),
    "python_for_with_tensor_if": (_for_with_if, (X,), (), "cond"),
    "try_except_around_tensor_if": (_try_except, (X,), (), "cond"),
    "yolo_style_box_head": (_box_head, (np.random.RandomState(2).randn(
        2, 8, 5, 5).astype("float32"),), (), "cond"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_case_matches_reference(name):
    make, args, static, staged = CASES[name]
    r = run_ref(make, args, static)
    p, fn = run_port(make, args)
    assert_same(r, p)
    # eagerly, the converted port function gives the same result
    e = convert_function(make(port))(*[_to_port(a) for a in args])
    assert_same(r, e)
    if staged is not None:
        names = ops_of(fn.graph(*[_to_port(a) for a in args]))
        assert any(staged in n for n in names), (staged, set(names))


# -- diagnostics, both packages ----------------------------------------------
def _early_return(pd):
    def f(x):
        if pd.sum(x) > 0:
            return x + 1
        return x - 1
    return f


def _return_in_while(pd):
    def f(x):
        s = pd.zeros([])
        while s < 10.0:
            s = s + pd.sum(x)
            if s > 5.0:
                return s
        return s
    return f


def _append_in_while(pd):
    def f(x):
        a = []
        i = pd.zeros([], "int32")
        while i < 3:
            a.append(x)
            i = i + 1
        return a
    return f


def _reassigned_loop_var(pd):
    def f(x, n):
        acc = x
        for i in range(n):
            acc = acc + i
            i = 0
        return acc
    return f


def _unroll_cap(pd):
    def f(x):
        acc = []
        s = x
        i = 0
        while i < 600:
            acc.append(s)
            s = s * 1.01
            i = i + 1
        return acc[-1]
    return f


def _read_before_assignment(pd):
    def f(x):
        s = x
        n = 0
        while n < 3:
            acc = acc + [s]  # noqa: F821
            s = s * 2.0
            n = n + 1
        return acc
    return f


DIAGNOSED = {
    "early_return": (_early_return, (np.ones((2,), "float32"),),
                     "return/break/continue"),
    "return_in_tensor_while": (_return_in_while, (POS,),
                               "return/break/continue"),
    "append_in_tensor_while": (_append_in_while, (X,), r"\.py:\d+.*fixed"),
    "for_target_reassigned": (_reassigned_loop_var,
                              (np.zeros((), "float32"),
                               np.asarray(3, "int32")),
                              "reassigns its loop"),
    "unroll_cap": (_unroll_cap, (np.ones(2, "float32"),), "unroll cap"),
    "read_before_assignment": (_read_before_assignment,
                               (np.ones(2, "float32"),), "read before"),
}


@pytest.mark.parametrize("name", list(DIAGNOSED))
def test_diagnostic_matches_reference(name):
    make, args, match = DIAGNOSED[name]
    with pytest.raises(RefError, match=match):
        run_ref(make, args)
    with pytest.raises(Dy2StaticError, match=match):
        run_port(make, args)


def test_diagnostic_points_at_real_line():
    f = _early_return(port)
    lineno = f.__code__.co_firstlineno + 1  # the `if` line
    with pytest.raises(Dy2StaticError, match=f":{lineno}:"):
        port.jit.to_static(f)(torch.ones(2))


def test_user_type_error_not_rebranded():
    def f(x):
        if port.sum(x) > 0:
            y = x + "oops"
        else:
            y = x
        return y

    with pytest.raises(TypeError):
        port.jit.to_static(f)(torch.ones(2))


def test_python_semantics_outside_a_trace():
    calls = []

    def rhs():
        calls.append(1)
        return True

    def f(flag):
        return flag and rhs()

    g = convert_function(f)
    assert g(False) is False and calls == []
    assert g(True) is True

    def h(x, n):
        out = x
        i = 0
        while i < n:
            out = out + 1
            if i == 2:
                break
            i += 1
        return out

    assert float(convert_function(h)(torch.zeros(()), 10)) == 3.0

    def k(x, items):
        s = x
        for i, v in enumerate(items):
            s = s + v * (i + 1)
        for u, w in zip(items, items):
            s = s + u * w
        return s

    assert float(convert_function(k)(torch.zeros(()), [1.0, 2.0])) == 10.0
    with pytest.raises(Dy2StaticError, match="0-d"):
        convert_function(_rows_zero_d)(torch.tensor(1.0))


def _rows_zero_d(x):
    s = torch.zeros(())
    for v in x:
        s = s + v
    return s


def _late_helper_caller(x):
    return _helper_defined_later(x)


def _helper_defined_later(x):
    return x * 3


def test_late_bound_global_and_imports():
    assert float(convert_function(_late_helper_caller)(
        torch.tensor(2.0))) == 6.0

    def f(flag, x):
        if flag:
            import math
            y = x + 1
        else:
            import math
            y = x - 1
        return y, math.pi

    y, pi = convert_function(f)(True, 1.0)
    assert y == 2.0 and abs(pi - 3.14159) < 1e-3


def test_declined_conversions_warn():
    class Base(tnn.Layer):
        def forward(self, x):
            return x + 1

    class Child(Base):
        def forward(self, x):
            return super().forward(x) * 2

    with pytest.warns(UserWarning, match="zero-arg super"):
        g = convert_function(Child.forward)
    assert float(g(Child(), torch.tensor(1.0))) == 4.0

    def f(x):
        global _SOME_GLOBAL
        _SOME_GLOBAL = 1
        return x

    with pytest.warns(UserWarning, match="global/nonlocal"):
        assert convert_function(f) is f

    def g2(x, n):
        out = x
        i = 0
        while i < n:
            for k in [1, 2]:
                out = out + k
            else:
                break
        return out

    assert float(convert_function(g2)(torch.zeros(()), 5)) == 3.0


def test_print_and_assert_run_with_the_graph(capsys):
    def f(x):
        print("value:", x)
        assert x.sum() > -1e9, "impossible"
        return x * 2

    fn = port.jit.to_static(f)
    out = fn(torch.ones(2))
    np.testing.assert_allclose(out.numpy(), 2.0)
    assert "value: tensor([1., 1.])" in capsys.readouterr().out
    # a second call replays the graph: the print op runs again
    fn(torch.full((2,), 3.0))
    assert "value: tensor([3., 3.])" in capsys.readouterr().out
    names = ops_of(fn.graph(torch.ones(2)))
    assert any("dy2static_print" in n for n in names)
    assert any("dy2static_assert" in n for n in names)

    def g(x):
        assert x.sum() > 1e9, "impossible"
        return x

    with pytest.raises(AssertionError, match="impossible"):
        port.jit.to_static(g)(torch.ones(2))

    def h(x, flag):
        assert flag, "flag must be set"
        return x

    with pytest.raises(AssertionError, match="flag must be set"):
        convert_function(h)(torch.ones(2), False)


def test_cache_update_in_tensor_if():
    def make(pd):
        def f(x, cache):
            if x.sum() > 0:
                cache["k"] = cache["k"] + x
            return cache["k"]
        return f

    r = jax.jit(ref_convert(make(ref)))(jnp.asarray(X),
                                        {"k": jnp.asarray(X * 0.5)})
    p = port.jit.to_static(make(port))(torch.from_numpy(X),
                                       {"k": torch.from_numpy(X * 0.5)})
    assert_same(r, p)


def test_grad_through_converted_control_flow():
    def make(pd):
        def f(x):
            if x.sum() > 0:
                r = (x * x).sum()
            else:
                r = x.sum()
            return r
        return f

    for x in (np.abs(X) + 0.1, -np.abs(X) - 0.1):
        g_ref = jax.grad(ref_convert(make(ref)))(jnp.asarray(x))
        xt = torch.from_numpy(x.copy()).requires_grad_(True)
        out = port.jit.to_static(make(port))(xt)
        (g,) = torch.autograd.grad(out, [xt])
        np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), **TOL)


def test_to_static_layers_match_reference():
    def make(pd):
        class Gate(pd.nn.Layer):
            def __init__(self):
                super().__init__()
                self.seq = pd.nn.Sequential(pd.nn.Linear(4, 8),
                                            pd.nn.ReLU(),
                                            pd.nn.Linear(8, 4))
                self.blocks = pd.nn.LayerList([pd.nn.Linear(4, 4)
                                               for _ in range(2)])

            def forward(self, x):
                h = self.seq(x)
                for blk in self.blocks:
                    h = blk(h)
                if h.sum() > 0:
                    out = h * 2.0
                else:
                    out = h * 0.5
                return out
        return Gate

    ref.seed(0)
    rnet = make(ref)()
    pnet = make(port)()
    pnet.set_state_dict_from_numpy(
        {k: np.asarray(v) for k, v in rnet.state_dict().items()})
    x = np.random.RandomState(3).randn(2, 4).astype("float32")
    r = ref.jit.to_static(rnet)(jnp.asarray(x))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        traced = port.jit.to_static(pnet)
    assert isinstance(traced, port.jit.TracedLayer)
    p = traced(torch.from_numpy(x))
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(r),
                               rtol=1e-5, atol=1e-6)
    assert any("cond" in n for n in ops_of(traced.graph(torch.from_numpy(x))))


def test_translator_disable_passthrough():
    from paddle_tpu_torch.jit import ProgramTranslator

    def f(x):
        return x + 1

    ProgramTranslator.get_instance().enable(False)
    try:
        assert port.jit.to_static(f) is f
    finally:
        ProgramTranslator.get_instance().enable(True)
    assert isinstance(port.jit.to_static(f), port.jit.StaticFunction)
