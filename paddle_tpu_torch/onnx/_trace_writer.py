"""Trace-based Layer -> ONNX conversion: a traced ATen graph -> ONNX nodes.

Port of ``paddle_tpu/onnx/_trace_writer.py``. The reference traces the
layer to a jaxpr and maps each primitive to ONNX ops; the port traces its
eval forward to a ``torch.fx`` graph of ATen ops and maps each op, which
covers the residual CNNs (ResNet) and the transformer blocks that the
layer walker (``_writer.py``) refuses.

Design:

- the forward is ``functional_call(layer, params, buffers, *inputs)``,
  functionalized (``torch.func.functionalize``, so no in-place or view
  node is left) and traced by ``make_fx`` on fake tensors: nothing is
  computed and nothing is allocated on the layer's device;
- parameters and buffers are graph inputs bound to their values: they
  are constants, and become initializers where a mapped node reads them
  (the reference's closed-over consts);
- every node whose inputs are all constants is computed at conversion
  time, on the host, and baked in as an initializer up to
  :data:`_FOLD_CAP` elements: this absorbs the causal mask, ``arange``,
  position ids and the parameter-only arithmetic (a batch norm's scale);
- a ``view`` that merely flattens the leading dims of a matmul's operand
  (``torch.matmul`` of a 3-D by a 2-D tensor traces as view, ``mm``,
  view) is not emitted: the ``MatMul`` takes the unflattened operand, as
  ONNX ``MatMul`` is batched, so the graph stays free of batch-sized
  shape constants;
- the port's flash-attention op (``paddle_tpu_torch.flash_attention_fwd``)
  maps to the ONNX subgraph of its plain version: scale, ``MatMul``, the
  causal mask as a folded ``Where``, ``Softmax``, ``MatMul``, in the op's
  (b, s, h, d) layout. It is a converter rule: the forward that runs on
  the card keeps the kernel. Every other node with no mapping (the other
  kernel ops among them, which no eval forward reaches) raises
  ``NotImplementedError("... has no ONNX mapping")`` and ``onnx.export``
  keeps the ``jit.save`` artifact.

Dtypes and batch follow the reference: exact dtypes (int32 inputs stay
INT32, bfloat16 maps to FLOAT), a dynamic batch traced at the sentinel
:data:`_DYN_SENTINEL`, a leading sentinel in a reshape whose input's
dim 0 is the batch written as 0, and a graph that bakes the batch in
refused and exported again at a static batch of 1 with a warning.
"""
from __future__ import annotations

import math
import operator
from typing import Dict, List

import numpy as np
import torch
import torch.utils._pytree as pytree

from . import _pb
from ._writer import _GraphBuilder, _model, _value_info

_FOLD_CAP = 4_000_000  # elements; larger constants abort folding

_DYN_SENTINEL = 13  # trace batch for dynamic-dim specs: a prime rare as
#                     a real model dim, so "== sentinel" identifies batch

#: the one kernel op with a mapping (its plain version's subgraph)
FLASH_OP = "paddle_tpu_torch::flash_attention_fwd"

# ONNX TensorProto.DataType under the exact-dtype policy (bf16 -> FLOAT)
_TORCH_TO_ONNX = {
    torch.float32: 1, torch.uint8: 2, torch.int8: 3, torch.int16: 5,
    torch.int32: 6, torch.int64: 7, torch.bool: 9, torch.float16: 10,
    torch.float64: 11, torch.bfloat16: 1,
}

# the masked scores of the flash op's plain version
_FLASH_NEG_INF = -1e30

_UNARY = {
    "neg": "Neg", "exp": "Exp", "log": "Log", "tanh": "Tanh", "erf": "Erf",
    "sqrt": "Sqrt", "abs": "Abs", "sign": "Sign", "floor": "Floor",
    "ceil": "Ceil", "sigmoid": "Sigmoid", "relu": "Relu",
    "reciprocal": "Reciprocal", "logical_not": "Not", "bitwise_not": "Not",
}
_BINARY = {
    "mul": "Mul", "div": "Div", "maximum": "Max", "minimum": "Min",
    "pow": "Pow", "logical_and": "And", "logical_or": "Or",
    "bitwise_and": "And", "bitwise_or": "Or",
}
_COMPARE = {"lt": "Less", "le": "LessOrEqual", "gt": "Greater",
            "ge": "GreaterOrEqual", "eq": "Equal"}
_RESHAPES = {"view", "view_copy", "_unsafe_view", "reshape",
             "_reshape_alias", "_reshape_alias_copy", "flatten"}
_ALIASES = {"clone", "alias", "alias_copy", "detach", "detach_copy",
            "lift_fresh_copy", "contiguous", "dropout"}
_PERMUTES = {"permute", "permute_copy"}
_TRANSPOSES = {"t", "t_copy", "transpose", "transpose_copy"}
_EXPANDS = {"expand", "expand_copy"}
_SPLITS = {"split", "split_copy", "split_with_sizes",
           "split_with_sizes_copy"}
_SLICES = {"slice", "slice_copy"}
_SELECTS = {"select", "select_copy"}
_LIKES = {"full_like": None, "zeros_like": 0.0, "ones_like": 1.0,
          "empty_like": 0.0}


def _onnx_dt(dtype) -> int:
    dt = _TORCH_TO_ONNX.get(dtype)
    if dt is None:
        raise NotImplementedError(f"dtype {dtype} in ONNX conversion")
    return dt


def _np_of(t: torch.Tensor) -> np.ndarray:
    """Initializer storage under the exact-dtype policy (bf16 -> f32)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _np_dtype(dtype: torch.dtype):
    return torch.empty((), dtype=(torch.float32 if dtype == torch.bfloat16
                                  else dtype)).numpy().dtype


def _bool_tensor(name: str, arr: np.ndarray) -> bytes:
    body = b"".join(_pb.f_varint(1, int(d)) for d in arr.shape)
    body += _pb.f_varint(2, 9)  # BOOL
    body += _pb.f_str(8, name)
    body += _pb.f_bytes(9, np.ascontiguousarray(
        arr.astype(np.uint8)).tobytes())
    return body


def _val(node):
    return node.meta.get("val") if isinstance(node, torch.fx.Node) else None


def _shape(node) -> List[int]:
    return [int(d) for d in _val(node).shape]


def _dtype(node) -> torch.dtype:
    return _val(node).dtype


def op_name(target) -> str:
    """``namespace::name`` of an op overload (``aten::add``)."""
    schema = getattr(target, "_schema", None)
    if schema is not None:
        return schema.name
    return getattr(target, "__name__", str(target))


class _Converter:
    def __init__(self, dyn_batch: int | None = None):
        self.g = _GraphBuilder()
        self.env: Dict = {}        # fx Node -> onnx name (or list of them)
        self.const: Dict = {}      # fx Node -> host tensor (foldable)
        # fx Node -> the shape of its ONNX tensor where that differs from
        # the node's own: a flattening view left unemitted for a MatMul
        self.actual: Dict = {}
        self._causal: Dict = {}    # (sq, sk) -> the flash nodes' mask
        # dynamic batch: the sentinel batch size the trace ran at. Shape
        # consts with a leading sentinel become 0 (ONNX Reshape "copy
        # input dim"); any OTHER appearance of the sentinel cannot be
        # made batch-polymorphic and raises, so the caller can fall back
        # to a static-batch export instead of emitting a wrong graph.
        self.dyn_batch = dyn_batch

    # -- helpers ------------------------------------------------------------
    def add_const(self, arr, hint="const") -> str:
        arr = np.asarray(arr)
        b = self.dyn_batch
        if b is not None:
            # batch-bake detection, as the reference's: a leading sentinel
            # that is provably the batch was rewritten to 0 before this
            # call, so any sentinel here is a bake (a false positive costs
            # a static export, never a wrong dynamic graph)
            if hint == "shape" and arr.ndim == 1:
                if b in arr or any(int(v) > b and int(v) % b == 0
                                   for v in arr):
                    raise NotImplementedError(
                        f"dynamic batch: shape constant {arr.tolist()} "
                        "bakes the batch size")
            elif b in arr.shape or (arr.ndim == 1 and arr.size <= 8
                                    and arr.dtype.kind == 'i'
                                    and b in arr):
                raise NotImplementedError(
                    "dynamic batch: a constant bakes the traced batch "
                    f"size (shape {arr.shape})")
            elif arr.ndim == 0 and arr.dtype.kind in "iuf" and (
                    float(arr) == float(b)
                    or abs(float(arr) - 1.0 / b) < 1e-9):
                raise NotImplementedError(
                    "dynamic batch: a scalar constant equals the traced "
                    "batch size (or its reciprocal) — likely a "
                    "batch-derived value")
        if arr.dtype == np.bool_:
            name = self.g.fresh(hint)
            self.g.initializers.append(_bool_tensor(name, arr))
            return name
        return self.g.add_init(hint, arr)

    def scalar(self, value, dtype: torch.dtype, hint="lit") -> str:
        return self.add_const(np.asarray(value, _np_dtype(dtype)), hint)

    def ints(self, values, hint="axes") -> str:
        return self.add_const(np.asarray(list(values), np.int64), hint)

    def is_const(self, a) -> bool:
        return not isinstance(a, torch.fx.Node) or (
            a in self.const and a not in self.env)

    def value(self, a):
        return self.const[a] if isinstance(a, torch.fx.Node) else a

    def raw(self, node) -> str:
        """The node's ONNX name as it stands (maybe a lazy flattening)."""
        if node not in self.env:
            v = self.const[node]
            if not isinstance(v, torch.Tensor):
                raise NotImplementedError(
                    f"non-tensor constant {type(v).__name__} as an input")
            self.env[node] = self.add_const(_np_of(v), "folded")
        return self.env[node]

    def name_of(self, node) -> str:
        """The node's ONNX name, its pending flattening emitted."""
        name = self.raw(node)
        if isinstance(name, list):
            raise NotImplementedError(
                f"tuple value of {node.name} used as a tensor")
        if node in self.actual:
            cur = self.actual.pop(node)
            if cur != _shape(node):
                name = self._reshape(name, cur, _shape(node))
                self.env[node] = name
        return name

    def shape_of(self, node) -> List[int]:
        """The shape of the node's ONNX tensor (its lazy one if pending)."""
        self.raw(node)
        return list(self.actual.get(node, _shape(node)))

    def operand(self, a, dtype: torch.dtype) -> str:
        """A tensor operand cast to ``dtype``, or a scalar as a constant
        of ``dtype`` (ONNX needs both operands of one type)."""
        if not isinstance(a, torch.fx.Node):
            return self.scalar(a, dtype)
        name = self.name_of(a)
        if _dtype(a) != dtype and _onnx_dt(_dtype(a)) != _onnx_dt(dtype):
            name = self.node("Cast", [name], attrs={"to": _onnx_dt(dtype)})
        return name

    def node(self, op, ins, n_out=1, attrs=None, hint=None):
        outs = [self.g.fresh(hint or op.lower()) for _ in range(n_out)]
        self.g.add_node(op, ins, outs, attrs)
        return outs if n_out != 1 else outs[0]

    def _reshape(self, name, in_shape, out_shape) -> str:
        target = np.asarray(out_shape, np.int64)
        b = self.dyn_batch
        if (b is not None and target.size and target[0] == b
                and in_shape and in_shape[0] == b):
            # the INPUT's dim 0 is the batch too, so ONNX Reshape's 0
            # ("copy input dim 0") is batch-polymorphic
            target = target.copy()
            target[0] = 0
        return self.node("Reshape", [name, self.add_const(target, "shape")])

    # -- the graph walk -------------------------------------------------------
    def convert(self, gm: torch.fx.GraphModule):
        for node in gm.graph.nodes:
            if node.op == "get_attr":
                self.const[node] = getattr(gm, node.target)
            elif node.op == "call_function":
                self.call(node)

    def _try_fold(self, node) -> bool:
        leaves = pytree.tree_leaves((node.args, node.kwargs))
        if not all(self.is_const(a) for a in leaves):
            return False
        if isinstance(node.target, torch._ops.OpOverload) and \
                not op_name(node.target).startswith("aten::"):
            return False  # a kernel op: map it, never run it here
        args, kwargs = pytree.tree_map(
            lambda a: self.const[a] if isinstance(a, torch.fx.Node) else a,
            (node.args, node.kwargs))
        if "device" in kwargs:
            kwargs = dict(kwargs, device="cpu")
        try:
            out = node.target(*args, **kwargs)
        except Exception:
            return False
        outs = out if isinstance(out, (tuple, list)) else [out]
        if any(isinstance(o, torch.Tensor) and o.numel() > _FOLD_CAP
               for o in outs):
            return False  # nothing stored: all-or-nothing fold
        self.const[node] = out
        return True

    def call(self, node):
        if not node.users:
            return  # dead: an output no one reads (a pool's indices)
        if node.target is operator.getitem:
            return self._getitem(node)
        if self._try_fold(node):
            return
        name = op_name(node.target)
        if name == FLASH_OP:
            return self.flash(node)
        ns, _, short = name.partition("::")
        fn = getattr(self, f"p_{short}", None) if ns == "aten" else None
        if fn is None:
            fn = self._family(short) if ns == "aten" else None
        if fn is None:
            raise NotImplementedError(f"op {name!r} has no ONNX mapping")
        fn(node)

    def _family(self, short):
        if short in _UNARY:
            return lambda n: self._unop(n, _UNARY[short])
        if short in _BINARY:
            return lambda n: self._binop(n, _BINARY[short])
        if short in _COMPARE:
            return lambda n: self._cmp(n, _COMPARE[short])
        for group, fn in ((_RESHAPES, self.p_view), (_ALIASES, self._alias),
                          (_PERMUTES, self.p_permute),
                          (_TRANSPOSES, self.p_transpose),
                          (_EXPANDS, self.p_expand), (_SPLITS, self.p_split),
                          (_SLICES, self.p_slice), (_SELECTS, self.p_select),
                          (_LIKES, self.p_like)):
            if short in group:
                return fn
        if short in ("squeeze", "squeeze_copy"):
            return self.p_squeeze
        if short in ("unsqueeze", "unsqueeze_copy"):
            return self.p_unsqueeze
        if short in ("max_pool2d_with_indices", "max_pool2d"):
            return self.p_max_pool
        if short in ("_native_batch_norm_legit_no_training",
                     "native_batch_norm"):
            return self.p_batch_norm
        return None

    def _getitem(self, node):
        src, i = node.args
        if src in self.const and src not in self.env:
            self.const[node] = self.const[src][i]
            return
        names = self.env[src]
        if names[i] is None:
            raise NotImplementedError(
                f"output {i} of {src.name} has no ONNX mapping")
        self.env[node] = names[i]

    def _alias(self, node):
        src = node.args[0]
        self.env[node] = self.raw(src)
        if src in self.actual and self.actual[src] != _shape(node):
            self.actual[node] = self.actual[src]

    # -- elementwise --------------------------------------------------------
    def _binop(self, node, op):
        dt = _dtype(node)
        a, b = node.args[:2]
        self.env[node] = self.node(op, [self.operand(a, dt),
                                        self.operand(b, dt)])
        if op == "Div" and node.kwargs.get("rounding_mode") is not None:
            if node.kwargs["rounding_mode"] != "floor":
                raise NotImplementedError("div with rounding_mode='trunc'")
            self.env[node] = self.node("Floor", [self.env[node]])

    def _addsub(self, node, op):
        dt = _dtype(node)
        a, b = node.args[:2]
        alpha = node.kwargs.get("alpha", 1)
        bn = self.operand(b, dt)
        if alpha != 1:
            bn = self.node("Mul", [bn, self.scalar(alpha, dt)])
        self.env[node] = self.node(op, [self.operand(a, dt), bn])

    def p_add(self, node):
        self._addsub(node, "Add")

    def p_sub(self, node):
        self._addsub(node, "Sub")

    def p_rsub(self, node):
        dt = _dtype(node)
        a, b = node.args[:2]
        self.env[node] = self.node("Sub", [self.operand(b, dt),
                                           self.operand(a, dt)])

    def _unop(self, node, op):
        x = node.args[0]
        self.env[node] = self.node(op, [self.operand(x, _dtype(node))])

    def p_rsqrt(self, node):
        s = self.node("Sqrt", [self.operand(node.args[0], _dtype(node))])
        self.env[node] = self.node("Reciprocal", [s])

    def _cmp(self, node, op):
        a, b = node.args[:2]
        dt = torch.promote_types(
            *[_dtype(x) if isinstance(x, torch.fx.Node)
              else torch.tensor(x).dtype for x in (a, b)])
        self.env[node] = self.node(op, [self.operand(a, dt),
                                        self.operand(b, dt)])

    def p_ne(self, node):
        self._cmp(node, "Equal")
        self.env[node] = self.node("Not", [self.env[node]])

    def p_where(self, node):
        cond, a, b = node.args
        dt = _dtype(node)
        self.env[node] = self.node(
            "Where", [self.operand(cond, torch.bool), self.operand(a, dt),
                      self.operand(b, dt)])

    def _clip(self, node, x, lo, hi):
        dt = _dtype(node)
        ins = [self.operand(x, dt),
               self.scalar(lo, dt) if lo is not None else "",
               self.scalar(hi, dt) if hi is not None else ""]
        while ins[-1] == "":
            ins.pop()
        self.env[node] = self.node("Clip", ins)

    def p_clamp(self, node):
        args = list(node.args) + [None, None]
        if any(isinstance(a, torch.fx.Node) for a in args[1:3]):
            raise NotImplementedError("clamp with tensor bounds")
        self._clip(node, args[0], args[1], args[2])

    def p_clamp_min(self, node):
        self._clip(node, node.args[0], node.args[1], None)

    def p_clamp_max(self, node):
        self._clip(node, node.args[0], None, node.args[1])

    def p_hardtanh(self, node):
        args = list(node.args) + [-1.0, 1.0]
        self._clip(node, args[0], args[1], args[2])

    def p__to_copy(self, node):
        x = node.args[0]
        if _dtype(x) == _dtype(node):
            return self._alias(node)
        self.env[node] = self.node("Cast", [self.name_of(x)],
                                   attrs={"to": _onnx_dt(_dtype(node))})

    def p_gelu(self, node):
        dt = _dtype(node)
        x = self.operand(node.args[0], dt)
        if node.kwargs.get("approximate", "none") == "tanh":
            # 0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)))
            x3 = self.node("Mul", [self.node("Mul", [x, x]), x])
            inner = self.node("Add", [x, self.node(
                "Mul", [x3, self.scalar(0.044715, dt)])])
            t = self.node("Tanh", [self.node(
                "Mul", [inner, self.scalar(math.sqrt(2.0 / math.pi), dt)])])
        else:
            # 0.5 x (1 + erf(x / sqrt(2)))
            t = self.node("Erf", [self.node(
                "Mul", [x, self.scalar(1.0 / math.sqrt(2.0), dt)])])
        one = self.node("Add", [t, self.scalar(1.0, dt)])
        half = self.node("Mul", [one, self.scalar(0.5, dt)])
        self.env[node] = self.node("Mul", [x, half])

    def p__softmax(self, node):
        x, dim = node.args[:2]
        self.env[node] = self.node("Softmax", [self.name_of(x)],
                                   attrs={"axis": int(dim)})

    def p__log_softmax(self, node):
        x, dim = node.args[:2]
        self.env[node] = self.node("LogSoftmax", [self.name_of(x)],
                                   attrs={"axis": int(dim)})

    def p_like(self, node):
        """``full_like``/``zeros_like``/... of a computed tensor: the fill
        expanded to the input's runtime shape (batch-polymorphic)."""
        fill = _LIKES[op_name(node.target).split("::")[1]]
        if fill is None:
            fill = node.args[1]
        shape = self.node("Shape", [self.name_of(node.args[0])])
        self.env[node] = self.node(
            "Expand", [self.scalar(fill, _dtype(node)), shape])

    # -- shape ops ----------------------------------------------------------
    def p_view(self, node):
        x = node.args[0]
        target = _shape(node)
        cur = self.shape_of(x)
        if cur == target:
            return self._alias(node)
        if (len(target) == 2 and len(cur) >= 3 and target[1] == cur[-1]
                and target[0] == math.prod(cur[:-1])):
            # flattens the leading dims: left for a MatMul to take whole
            self.env[node] = self.raw(x)
            self.actual[node] = cur
            return
        self.env[node] = self._reshape(self.raw(x), cur, target)

    def p_squeeze(self, node):
        x = node.args[0]
        shape = _shape(x)
        dims = node.args[1] if len(node.args) > 1 else None
        if dims is None:
            dims = [i for i, d in enumerate(shape) if d == 1]
        dims = [dims] if isinstance(dims, int) else list(dims)
        dims = [d % max(len(shape), 1) for d in dims if shape[d] == 1]
        if not dims:
            return self._alias(node)
        self.env[node] = self.node("Squeeze", [self.name_of(x),
                                               self.ints(dims)])

    def p_unsqueeze(self, node):
        x, dim = node.args[:2]
        dim = dim % (len(_shape(x)) + 1)
        self.env[node] = self.node("Unsqueeze", [self.name_of(x),
                                                 self.ints([dim])])

    def p_permute(self, node):
        x, perm = node.args[:2]
        n = len(_shape(x))
        self.env[node] = self.node("Transpose", [self.name_of(x)],
                                   attrs={"perm": [int(p) % n for p in perm]})

    def p_transpose(self, node):
        x = node.args[0]
        n = len(_shape(x))
        if len(node.args) >= 3:
            d0, d1 = int(node.args[1]) % n, int(node.args[2]) % n
        else:
            d0, d1 = 0, 1
        perm = list(range(n))
        perm[d0], perm[d1] = perm[d1], perm[d0]
        self.env[node] = self.node("Transpose", [self.name_of(x)],
                                   attrs={"perm": perm})

    def p_expand(self, node):
        x = node.args[0]
        out = _shape(node)
        src = [1] * (len(out) - len(_shape(x))) + _shape(x)
        tgt = list(out)
        if self.dyn_batch is not None:
            for i, (m, o) in enumerate(zip(src, out)):
                if o == self.dyn_batch:
                    if m != o:
                        raise NotImplementedError(
                            "dynamic batch: broadcast ALONG the batch dim "
                            "bakes the batch size")
                    tgt[i] = 1  # Expand's 1 keeps the input dim
        self.env[node] = self.node(
            "Expand", [self.name_of(x),
                       self.add_const(np.asarray(tgt, np.int64), "shape")])

    def p_cat(self, node):
        tensors = node.args[0]
        dim = node.args[1] if len(node.args) > 1 else 0
        dt = _dtype(node)
        self.env[node] = self.node(
            "Concat", [self.operand(t, dt) for t in tensors],
            attrs={"axis": int(dim)})

    def p_split(self, node):
        x = node.args[0]
        dim = node.args[2] if len(node.args) > 2 else 0
        sizes = [int(v.shape[dim]) for v in _val(node)]
        outs = self.node("Split", [self.name_of(x), self.ints(sizes, "split")],
                         n_out=len(sizes), attrs={"axis": int(dim)})
        self.env[node] = outs if isinstance(outs, list) else [outs]

    def p_slice(self, node):
        x = node.args[0]
        args = list(node.args[1:]) + [None] * 4
        dim = args[0] if args[0] is not None else 0
        start = args[1] if args[1] is not None else 0
        end = args[2] if args[2] is not None else 2 ** 63 - 1
        step = args[3] if args[3] is not None else 1
        if any(isinstance(v, torch.fx.Node) for v in (start, end, step)):
            raise NotImplementedError("slice with tensor bounds")
        end = min(int(end), 2 ** 63 - 1)
        self.env[node] = self.node(
            "Slice", [self.name_of(x), self.ints([start], "starts"),
                      self.ints([end], "ends"), self.ints([dim], "axes"),
                      self.ints([step], "steps")])

    def p_select(self, node):
        x, dim, index = node.args[:3]
        idx = self.add_const(np.asarray(int(index), np.int64), "index")
        self.env[node] = self.node("Gather", [self.name_of(x), idx],
                                   attrs={"axis": int(dim)})

    def p_index(self, node):
        x, indices = node.args[:2]
        if len(indices) != 1 or indices[0] is None:
            raise NotImplementedError("general aten.index pattern")
        self.env[node] = self.node(
            "Gather", [self.name_of(x), self.name_of(indices[0])],
            attrs={"axis": 0})

    def p_embedding(self, node):
        weight, ids = node.args[:2]
        self.env[node] = self.node(
            "Gather", [self.name_of(weight), self.name_of(ids)],
            attrs={"axis": 0})

    def p_constant_pad_nd(self, node):
        x, pad = node.args[:2]
        value = node.args[2] if len(node.args) > 2 else 0.0
        n = len(_shape(x))
        lo, hi = [0] * n, [0] * n
        for i in range(len(pad) // 2):       # pairs from the last dim
            lo[n - 1 - i], hi[n - 1 - i] = int(pad[2 * i]), int(pad[2 * i + 1])
        if any(v < 0 for v in lo + hi):
            raise NotImplementedError("negative padding")
        self.env[node] = self.node(
            "Pad", [self.name_of(x), self.ints(lo + hi, "pads"),
                    self.scalar(value, _dtype(node), "padval")])

    # -- reductions ---------------------------------------------------------
    def _dims(self, x, dims):
        n = len(_shape(x))
        if dims is None or (isinstance(dims, (list, tuple)) and not dims):
            return list(range(n))
        dims = [dims] if isinstance(dims, int) else dims
        return sorted(int(d) % n for d in dims)

    def p_sum(self, node):
        x = node.args[0]
        dims = self._dims(x, node.args[1] if len(node.args) > 1 else None)
        keep = bool(node.args[2]) if len(node.args) > 2 else \
            bool(node.kwargs.get("keepdim", False))
        self.env[node] = self.node(
            "ReduceSum", [self.operand(x, _dtype(node)), self.ints(dims)],
            attrs={"keepdims": int(keep)})

    def _reduce_attr(self, node, op, x, dims, keep):
        self.env[node] = self.node(
            op, [self.operand(x, _dtype(node))],
            attrs={"axes": self._dims(x, dims), "keepdims": int(keep)})

    def p_mean(self, node):
        x = node.args[0]
        dims = node.args[1] if len(node.args) > 1 else None
        keep = node.args[2] if len(node.args) > 2 else \
            node.kwargs.get("keepdim", False)
        self._reduce_attr(node, "ReduceMean", x, dims, keep)

    def p_amax(self, node):
        x = node.args[0]
        self._reduce_attr(node, "ReduceMax", x,
                          node.args[1] if len(node.args) > 1 else None,
                          node.args[2] if len(node.args) > 2 else False)

    def p_amin(self, node):
        x = node.args[0]
        self._reduce_attr(node, "ReduceMin", x,
                          node.args[1] if len(node.args) > 1 else None,
                          node.args[2] if len(node.args) > 2 else False)

    def p_var(self, node):
        """Decomposed: ReduceMean((x - mean)^2) * n / (n - correction)."""
        x = node.args[0]
        dims = self._dims(x, node.args[1] if len(node.args) > 1 else None)
        corr = node.kwargs.get("correction", 1)
        keep = bool(node.kwargs.get("keepdim", False))
        dt = _dtype(node)
        xn = self.operand(x, dt)
        m = self.node("ReduceMean", [xn], attrs={"axes": dims,
                                                 "keepdims": 1})
        d = self.node("Sub", [xn, m])
        v = self.node("ReduceMean", [self.node("Mul", [d, d])],
                      attrs={"axes": dims, "keepdims": int(keep)})
        n = math.prod(_shape(x)[i] for i in dims)
        if corr:
            v = self.node("Mul", [v, self.scalar(n / (n - corr), dt)])
        self.env[node] = v

    def p_argmax(self, node):
        x = node.args[0]
        dim = node.args[1] if len(node.args) > 1 else None
        keep = node.args[2] if len(node.args) > 2 else False
        if dim is None:
            raise NotImplementedError("argmax over the flattened tensor")
        self.env[node] = self.node("ArgMax", [self.name_of(x)],
                                   attrs={"axis": int(dim),
                                          "keepdims": int(keep)})

    # -- matmul / conv / pool / norm ----------------------------------------
    def _matmul(self, node, a, b):
        """MatMul of a's (maybe unflattened) tensor by a 2-D b; the
        result's shape stays lazy where a's was."""
        bn = self.name_of(b)
        if a in self.actual and len(_shape(b)) == 2:
            shape = self.actual[a]
            out = self.node("MatMul", [self.raw(a), bn])
            self.actual[node] = shape[:-1] + [_shape(b)[-1]]
            return out
        return self.node("MatMul", [self.name_of(a), bn])

    def p_mm(self, node):
        self.env[node] = self._matmul(node, *node.args[:2])

    def p_bmm(self, node):
        a, b = node.args[:2]
        self.env[node] = self.node("MatMul", [self.name_of(a),
                                              self.name_of(b)])

    def p_matmul(self, node):
        self.p_bmm(node)

    def p_addmm(self, node):
        bias, a, b = node.args[:3]
        beta = node.kwargs.get("beta", 1)
        alpha = node.kwargs.get("alpha", 1)
        if a not in self.actual:
            self.env[node] = self.node(
                "Gemm", [self.name_of(a), self.name_of(b),
                         self.operand(bias, _dtype(node))],
                attrs={"alpha": float(alpha), "beta": float(beta),
                       "transA": 0, "transB": 0})
            return
        if (alpha, beta) != (1, 1):
            raise NotImplementedError("addmm with alpha/beta on N-D input")
        mm = self._matmul(node, a, b)
        self.env[node] = self.node("Add", [mm, self.operand(
            bias, _dtype(node))])

    def p_convolution(self, node):
        (x, w, bias, stride, padding, dilation, transposed, _out_pad,
         groups) = node.args[:9]
        if transposed:
            raise NotImplementedError("transposed convolution")
        pads = [int(p) for p in padding]
        ins = [self.name_of(x), self.name_of(w)]
        if bias is not None:
            ins.append(self.name_of(bias))
        self.env[node] = self.node("Conv", ins, attrs={
            "strides": [int(s) for s in stride], "pads": pads + pads,
            "dilations": [int(d) for d in dilation], "group": int(groups)})

    def p_max_pool(self, node):
        args = list(node.args) + [None] * 6
        x, kernel, stride, padding, dilation, ceil = args[:6]
        kernel = list(kernel)
        stride = list(stride) if stride else kernel
        padding = list(padding) if padding is not None else [0]
        if len(padding) == 1:
            padding = padding * len(kernel)
        if dilation and any(int(d) != 1 for d in dilation):
            raise NotImplementedError("dilated pooling")
        attrs = {"kernel_shape": [int(k) for k in kernel],
                 "strides": [int(s) for s in stride],
                 "pads": [int(p) for p in padding] * 2}
        if ceil:
            attrs["ceil_mode"] = 1
        out = self.node("MaxPool", [self.name_of(x)], attrs=attrs)
        multi = op_name(node.target).endswith("with_indices")
        self.env[node] = [out, None] if multi else out

    def p_avg_pool2d(self, node):
        args = list(node.args) + [None] * 7
        x, kernel, stride, padding, ceil, include_pad, div = args[:7]
        if div is not None:
            raise NotImplementedError("avg_pool2d with divisor_override")
        kernel = list(kernel)
        stride = list(stride) if stride else kernel
        padding = list(padding) if padding is not None else [0]
        if len(padding) == 1:
            padding = padding * len(kernel)
        attrs = {"kernel_shape": [int(k) for k in kernel],
                 "strides": [int(s) for s in stride],
                 "pads": [int(p) for p in padding] * 2,
                 "count_include_pad": int(include_pad is None
                                          or bool(include_pad))}
        if ceil:
            attrs["ceil_mode"] = 1
        self.env[node] = self.node("AveragePool", [self.name_of(x)],
                                   attrs=attrs)

    def p__adaptive_avg_pool2d(self, node):
        if [int(s) for s in node.args[1]] != [1, 1]:
            raise NotImplementedError("adaptive_avg_pool2d only to (1, 1)")
        self.env[node] = self.node("GlobalAveragePool",
                                   [self.name_of(node.args[0])])

    def p_batch_norm(self, node):
        x, w, b, mean, var = node.args[:5]
        if op_name(node.target).endswith("native_batch_norm") and \
                node.args[5]:
            raise NotImplementedError("batch norm in training mode")
        eps = float(node.args[-1])
        n = _shape(x)[1]
        dt = _dtype(x)
        scale = self.name_of(w) if w is not None else \
            self.add_const(np.ones(n, _np_dtype(dt)), "bn_scale")
        bias = self.name_of(b) if b is not None else \
            self.add_const(np.zeros(n, _np_dtype(dt)), "bn_bias")
        out = self.node("BatchNormalization",
                        [self.name_of(x), scale, bias, self.name_of(mean),
                         self.name_of(var)], attrs={"epsilon": eps})
        self.env[node] = [out, None, None]

    def p_native_layer_norm(self, node):
        """Decomposed (opset 13 has no LayerNormalization): (x - mean) /
        sqrt(var + eps) * w + b over the normalized trailing dims."""
        x, shape, w, b, eps = node.args[:5]
        rank = len(_shape(x))
        axes = list(range(rank - len(shape), rank))
        dt = _dtype(x)
        xn = self.name_of(x)
        m = self.node("ReduceMean", [xn], attrs={"axes": axes,
                                                 "keepdims": 1})
        d = self.node("Sub", [xn, m])
        v = self.node("ReduceMean", [self.node("Mul", [d, d])],
                      attrs={"axes": axes, "keepdims": 1})
        r = self.node("Reciprocal", [self.node("Sqrt", [self.node(
            "Add", [v, self.scalar(float(eps), dt)])])])
        out = self.node("Mul", [d, r])
        if w is not None:
            out = self.node("Mul", [out, self.name_of(w)])
        if b is not None:
            out = self.node("Add", [out, self.name_of(b)])
        self.env[node] = [out, None, None]

    # -- the flash op -------------------------------------------------------
    def flash(self, node):
        """``flash_attention_fwd`` -> its plain version's subgraph:
        softmax(q k^T * scale, causal) v in the op's (b, s, h, d) layout,
        scores in float32. Only ``out`` maps; ``lse`` raises if read."""
        (q, k, v, lens, seed, sm_scale, causal, rate) = node.args[:8]
        if lens is not None:
            raise NotImplementedError(
                f"op {FLASH_OP!r} with kv_lens has no ONNX mapping")
        if float(rate) > 0.0 or seed is not None:
            raise NotImplementedError(
                f"op {FLASH_OP!r} with dropout has no ONNX mapping")
        dt = _dtype(q)
        f32 = torch.float32
        sq, sk = _shape(q)[1], _shape(k)[1]
        qn = self.operand(q, f32)
        kn = self.operand(k, f32)
        vn = self.operand(v, f32)
        qh = self.node("Transpose", [qn], attrs={"perm": [0, 2, 1, 3]})
        kt = self.node("Transpose", [kn], attrs={"perm": [0, 2, 3, 1]})
        vh = self.node("Transpose", [vn], attrs={"perm": [0, 2, 1, 3]})
        qs = self.node("Mul", [qh, self.scalar(float(sm_scale), f32)])
        s = self.node("MatMul", [qs, kt])                     # (b, h, sq, sk)
        if causal:
            # one initializer a shape, shared by every layer's node
            if (sq, sk) not in self._causal:
                self._causal[(sq, sk)] = self.add_const(
                    np.tril(np.ones((sq, sk), np.bool_)), "causal")
            s = self.node("Where", [self._causal[(sq, sk)], s,
                                    self.scalar(_FLASH_NEG_INF, f32)])
        p = self.node("Softmax", [s], attrs={"axis": -1})
        o = self.node("MatMul", [p, vh])                      # (b, h, sq, d)
        out = self.node("Transpose", [o], attrs={"perm": [0, 2, 1, 3]})
        if _onnx_dt(dt) != _onnx_dt(f32):
            out = self.node("Cast", [out], attrs={"to": _onnx_dt(dt)})
        self.env[node] = [out, None]


def trace_graph(fn, example_args) -> torch.fx.GraphModule:
    """``fn(*example_args)`` functionalized and traced by ``make_fx`` on
    fake tensors, without gradients."""
    from torch.fx.experimental.proxy_tensor import make_fx
    with torch.no_grad():
        return make_fx(torch.func.functionalize(
            fn, remove="mutations_and_views"),
            tracing_mode="fake")(*example_args)


def trace_to_onnx(fn, example_args, path: str, opset_version: int = 13,
                  n_consts: int = 0, input_names=None,
                  dyn_batch: int | None = None, dynamic_inputs=None) -> str:
    """Trace ``fn(*example_args)`` and write an ONNX model. The first
    ``n_consts`` leaves of the arguments (a layer's parameters and
    buffers) are constants: initializers where a mapped node reads them.
    With ``dyn_batch`` (the sentinel batch the example inputs carry),
    leading dims equal to it are declared as the dynamic "N" dim_param
    and shape constants are rewritten batch-polymorphically (or the
    conversion raises NotImplementedError for graphs that bake the batch
    in: callers retry statically)."""
    gm = trace_graph(fn, example_args)
    leaves = pytree.tree_leaves(example_args)
    places = [n for n in gm.graph.nodes if n.op == "placeholder"]
    conv = _Converter(dyn_batch=dyn_batch)
    inputs = places[n_consts:]
    for node, value in zip(places[:n_consts], leaves[:n_consts]):
        conv.const[node] = value.detach().cpu()
    input_names = input_names or [f"input_{i}" for i in range(len(inputs))]

    def _dims(shape, dynamic=True):
        # `dynamic` gates per input: a spec whose batch dim was STATIC
        # keeps its literal size even if it coincides with the sentinel
        # (outputs are always batch-carrying when any input is)
        return [None if (dynamic and dyn_batch is not None and i == 0
                         and d == dyn_batch) else int(d)
                for i, d in enumerate(shape)]

    dyn_flags = dynamic_inputs if dynamic_inputs is not None else \
        [True] * len(inputs)
    graph_inputs = []
    for name, node, dyn in zip(input_names, inputs, dyn_flags):
        conv.env[node] = name
        graph_inputs.append(_value_info(
            name, _dims(_shape(node), dyn), _onnx_dt(_dtype(node))))
    conv.convert(gm)
    out_node = next(n for n in gm.graph.nodes if n.op == "output")
    outs = pytree.tree_leaves(out_node.args[0])
    out_infos = []
    for i, ov in enumerate(outs):
        oname = f"output_{i}"
        conv.g.add_node("Identity", [conv.name_of(ov)], [oname])
        val = conv.const[ov] if ov in conv.const else _val(ov)
        out_infos.append(_value_info(
            oname, _dims(list(val.shape)), _onnx_dt(val.dtype)))
    g = conv.g
    graph = b"".join(_pb.f_bytes(1, n) for n in g.nodes)
    graph += _pb.f_str(2, "paddle_tpu_torch_traced")
    graph += b"".join(_pb.f_bytes(5, t) for t in g.initializers)
    graph += b"".join(_pb.f_bytes(11, vi) for vi in graph_inputs)
    graph += b"".join(_pb.f_bytes(12, vi) for vi in out_infos)
    model = _model(graph, opset_version)
    with open(path, "wb") as f:
        f.write(model)
    return path


def export_traced_layer(layer, path: str, input_spec,
                        opset_version: int = 13) -> str:
    """Layer -> ONNX via the traced graph (eval mode, parameters and
    buffers as constants), on the device the layer's weights are on.

    A leading ``None``/-1 dim in the input spec exports a dynamic batch
    dim (dim_param "N") when the traced graph is batch-polymorphic;
    graphs that bake the batch in (folded batch-shaped constants,
    flattened-batch reshapes) fall back to a static batch of 1 with a
    warning."""
    from ..jit import _torch_dtype
    from ..jit.functionalization import functional_call, state_of
    from ..ops import flash_attention
    was_training = getattr(layer, "training", False)
    layer.eval()
    try:
        params, buffers = state_of(layer)
        params = {k: v.detach() for k, v in params.items()}
        buffers = {k: v.detach() for k, v in buffers.items()}
        state = list(params.values()) + list(buffers.values())
        device = state[0].device if state else torch.device("cpu")
        specs = input_spec if isinstance(input_spec, (list, tuple)) \
            else [input_spec]

        def _args(batch):
            out = []
            for s in specs:
                shape = [batch if (d is None
                                   or (isinstance(d, int) and d < 0))
                         else int(d) for d in getattr(s, "shape", s)]
                dtype = _torch_dtype(getattr(s, "dtype", None)
                                     or torch.float32)
                out.append(torch.zeros(shape, dtype=dtype, device=device))
            return out

        def fn(p, b, *xs):
            out, _ = functional_call(layer, p, b, *xs)
            return out

        def _spec_dynamic(s):
            sh = list(getattr(s, "shape", s))
            return len(sh) > 0 and (sh[0] is None or (
                isinstance(sh[0], int) and sh[0] < 0))

        n_consts = len(state)
        dyn_flags = [_spec_dynamic(s) for s in specs]
        with flash_attention.exporting():
            if any(dyn_flags):
                try:
                    return trace_to_onnx(
                        fn, (params, buffers, *_args(_DYN_SENTINEL)), path,
                        opset_version=opset_version, n_consts=n_consts,
                        dyn_batch=_DYN_SENTINEL, dynamic_inputs=dyn_flags)
                except NotImplementedError as e:
                    if "dynamic batch" not in str(e):
                        raise
                    import warnings
                    warnings.warn(
                        f"ONNX dynamic batch not expressible for this graph "
                        f"({e}); exporting with a static batch of 1")
            return trace_to_onnx(fn, (params, buffers, *_args(1)), path,
                                 opset_version=opset_version,
                                 n_consts=n_consts)
    finally:
        if was_training:
            layer.train()
