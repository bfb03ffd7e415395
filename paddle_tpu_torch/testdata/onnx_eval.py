"""A small ONNX evaluator in plain PyTorch, for tests and ``chip_smoke.py``.

It reads a file written by either package's ONNX writers (the layer
walker and the trace converter of ``paddle_tpu.onnx`` and
``paddle_tpu_torch.onnx``) with the dependency-free protobuf decoder and
runs its nodes in order on torch tensors, on any device. It knows the
ops those writers emit, at opset 13, and raises on any other. It is a
test helper, not API: no ONNX runtime is installed on either machine.

    model = load(path)
    outs = run(model, [x], device="cuda")
"""
from __future__ import annotations

import math
import struct
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.onnx import _pb

__all__ = ["load", "run", "op_types", "Model"]

# TensorProto.DataType -> torch dtype
_DTYPES = {1: torch.float32, 2: torch.uint8, 3: torch.int8, 5: torch.int16,
           6: torch.int32, 7: torch.int64, 9: torch.bool, 10: torch.float16,
           11: torch.float64}
_NP = {1: np.float32, 2: np.uint8, 3: np.int8, 5: np.int16, 6: np.int32,
       7: np.int64, 9: np.uint8, 10: np.float16, 11: np.float64}


def _s64(v: int) -> int:
    """A decoded varint as a signed int64."""
    return v - (1 << 64) if v >= 1 << 63 else v


def _attr(buf: bytes):
    a = _pb.decode(buf)
    name = a[1][0].decode()
    kind = a[20][0]
    if kind == 1:                                   # FLOAT
        return name, struct.unpack("<f", struct.pack("<i", a[2][0]))[0]
    if kind == 2:                                   # INT
        return name, _s64(a[3][0])
    if kind == 7:                                   # INTS
        return name, [_s64(v) for v in a.get(8, [])]
    raise NotImplementedError(f"attribute type {kind} of {name}")


def _tensor(buf: bytes):
    t = _pb.decode(buf)
    dims = [int(d) for d in t.get(1, [])]
    dt = t[2][0]
    raw = t[9][0] if 9 in t else b""
    arr = np.frombuffer(raw, dtype=_NP[dt]).reshape(dims).copy()
    out = torch.from_numpy(arr)
    if dt == 9:
        out = out.to(torch.bool)
    return t[8][0].decode(), out


def _value_info(buf: bytes):
    d = _pb.decode(buf)
    name = d[1][0].decode()
    ttype = _pb.decode(_pb.decode(d[2][0])[1][0])
    dims = []
    for dim in _pb.decode(ttype[2][0]).get(1, []) if 2 in ttype else []:
        dd = _pb.decode(dim)
        dims.append(dd[1][0] if 1 in dd else dd[2][0].decode())
    return name, ttype[1][0], dims


class Model:
    """A decoded ONNX file: nodes ``(op, inputs, outputs, attrs)``,
    initializers by name, graph inputs and outputs ``(name, elem, dims)``
    and the producer's name."""

    def __init__(self, buf: bytes):
        m = _pb.decode(buf)
        self.producer = m[2][0].decode() if 2 in m else ""
        self.opset = _pb.decode(m[8][0])[2][0]
        g = _pb.decode(m[7][0])
        self.nodes = []
        for nb in g.get(1, []):
            n = _pb.decode(nb)
            self.nodes.append((
                n[4][0].decode(), [i.decode() for i in n.get(1, [])],
                [o.decode() for o in n.get(2, [])],
                dict(_attr(a) for a in n.get(5, []))))
        self.initializers: Dict[str, torch.Tensor] = dict(
            _tensor(t) for t in g.get(5, []))
        self.inputs = [_value_info(v) for v in g.get(11, [])]
        self.outputs = [_value_info(v) for v in g.get(12, [])]


def load(path: str) -> Model:
    with open(path, "rb") as f:
        return Model(f.read())


def op_types(model: Model) -> List[str]:
    return [n[0] for n in model.nodes]


def _ints(t) -> List[int]:
    return [int(v) for v in t.reshape(-1).tolist()]


def _pads(x, pads, value=0.0):
    """ONNX pads [b1..bn, e1..en] over the last n dims as F.pad wants."""
    n = len(pads) // 2
    flat = []
    for i in reversed(range(n)):
        flat += [pads[i], pads[n + i]]
    return F.pad(x, flat, value=value)


def _pool(x, a, kind):
    k = a["kernel_shape"]
    n = len(k)
    strides = a.get("strides", [1] * n)
    pads = a.get("pads", [0] * (2 * n))
    ceil = bool(a.get("ceil_mode", 0))
    sym = pads[:n] == pads[n:]
    if kind == "max":
        if not sym:
            x, pads = _pads(x, pads, float("-inf")), [0] * (2 * n)
        fn = (F.max_pool1d, F.max_pool2d, F.max_pool3d)[n - 1]
        return fn(x, k, strides, pads[:n], ceil_mode=ceil)
    include = bool(a.get("count_include_pad", 0))
    if not sym:
        raise NotImplementedError("asymmetric AveragePool pads")
    fn = (F.avg_pool1d, F.avg_pool2d, F.avg_pool3d)[n - 1]
    return fn(x, k, strides, pads[:n], ceil_mode=ceil,
              count_include_pad=include)


def _conv(x, w, b, a):
    n = w.dim() - 2
    strides = a.get("strides", [1] * n)
    pads = a.get("pads", [0] * (2 * n))
    dil = a.get("dilations", [1] * n)
    if pads[:n] != pads[n:]:
        x, pads = _pads(x, pads), [0] * (2 * n)
    fn = (F.conv1d, F.conv2d, F.conv3d)[n - 1]
    return fn(x, w, b, strides, pads[:n], dil, a.get("group", 1))


def _axes(x, a, ins, default_all=True):
    if len(ins) > 1 and ins[1] is not None:
        axes = _ints(ins[1])
    else:
        axes = a.get("axes")
    if axes is None:
        axes = list(range(x.dim())) if default_all else []
    return [d % max(x.dim(), 1) for d in axes]


def _reduce(fn, x, a, ins):
    axes = _axes(x, a, ins)
    keep = bool(a.get("keepdims", 1))
    if not axes:
        return x
    out = x
    for d in sorted(axes, reverse=True):
        out = fn(out, d, True)
    if not keep:
        for d in sorted(axes, reverse=True):
            out = out.squeeze(d)
    return out


def _slice(x, ins):
    starts, ends = _ints(ins[1]), _ints(ins[2])
    axes = _ints(ins[3]) if len(ins) > 3 and ins[3] is not None else \
        list(range(len(starts)))
    steps = _ints(ins[4]) if len(ins) > 4 and ins[4] is not None else \
        [1] * len(starts)
    idx = [slice(None)] * x.dim()
    for s, e, ax, st in zip(starts, ends, axes, steps):
        n = x.shape[ax]
        s = max(0, min(n, s + n if s < 0 else s))
        e = max(0, min(n, e + n if e < 0 else e))
        idx[ax % x.dim()] = slice(s, e, st)
    return x[tuple(idx)]


def _reshape(x, shape):
    shape = [x.shape[i] if v == 0 else v for i, v in enumerate(shape)]
    return x.reshape(shape)


def _expand(x, shape):
    return x.expand(torch.broadcast_shapes(tuple(x.shape), tuple(shape)))


def _gemm(ins, a):
    A, B = ins[0], ins[1]
    if a.get("transA", 0):
        A = A.transpose(0, 1)
    if a.get("transB", 0):
        B = B.transpose(0, 1)
    y = a.get("alpha", 1.0) * (A @ B)
    if len(ins) > 2 and ins[2] is not None:
        y = y + a.get("beta", 1.0) * ins[2]
    return y


def _bn(ins, a):
    x, scale, bias, mean, var = ins
    shape = [1, -1] + [1] * (x.dim() - 2)
    inv = torch.rsqrt(var.reshape(shape) + a.get("epsilon", 1e-5))
    return (x - mean.reshape(shape)) * inv * scale.reshape(shape) + \
        bias.reshape(shape)


def _div(a, b):
    if a.is_floating_point():
        return a / b
    return torch.div(a, b, rounding_mode="trunc")


def _clip(ins):
    x = ins[0]
    lo = ins[1] if len(ins) > 1 and ins[1] is not None else None
    hi = ins[2] if len(ins) > 2 and ins[2] is not None else None
    return torch.clamp(x, min=lo, max=hi)


def _split(x, ins, a, n_out):
    axis = a.get("axis", 0)
    if len(ins) > 1 and ins[1] is not None:
        return list(torch.split(x, _ints(ins[1]), dim=axis))
    return list(torch.chunk(x, n_out, dim=axis))


_ELEMENTWISE = {
    "Add": lambda i, a: i[0] + i[1], "Sub": lambda i, a: i[0] - i[1],
    "Mul": lambda i, a: i[0] * i[1], "Div": lambda i, a: _div(i[0], i[1]),
    "Pow": lambda i, a: torch.pow(i[0], i[1]),
    "Max": lambda i, a: torch.maximum(i[0], i[1]),
    "Min": lambda i, a: torch.minimum(i[0], i[1]),
    "Neg": lambda i, a: -i[0], "Exp": lambda i, a: torch.exp(i[0]),
    "Log": lambda i, a: torch.log(i[0]), "Tanh": lambda i, a: torch.tanh(i[0]),
    "Erf": lambda i, a: torch.erf(i[0]), "Sqrt": lambda i, a: torch.sqrt(i[0]),
    "Reciprocal": lambda i, a: torch.reciprocal(i[0]),
    "Abs": lambda i, a: torch.abs(i[0]), "Sign": lambda i, a: torch.sign(i[0]),
    "Floor": lambda i, a: torch.floor(i[0]),
    "Ceil": lambda i, a: torch.ceil(i[0]),
    "Sigmoid": lambda i, a: torch.sigmoid(i[0]),
    "Relu": lambda i, a: torch.relu(i[0]),
    "Elu": lambda i, a: F.elu(i[0], a.get("alpha", 1.0)),
    "Selu": lambda i, a: F.selu(i[0]),
    "Softplus": lambda i, a: F.softplus(i[0]),
    "Softsign": lambda i, a: F.softsign(i[0]),
    "LeakyRelu": lambda i, a: F.leaky_relu(i[0], a.get("alpha", 0.01)),
    "Not": lambda i, a: torch.logical_not(i[0]),
    "And": lambda i, a: torch.logical_and(i[0], i[1]),
    "Or": lambda i, a: torch.logical_or(i[0], i[1]),
    "Equal": lambda i, a: i[0] == i[1], "Less": lambda i, a: i[0] < i[1],
    "LessOrEqual": lambda i, a: i[0] <= i[1],
    "Greater": lambda i, a: i[0] > i[1],
    "GreaterOrEqual": lambda i, a: i[0] >= i[1],
    "Where": lambda i, a: torch.where(i[0], i[1], i[2]),
    "Identity": lambda i, a: i[0], "Clip": lambda i, a: _clip(i),
}

_OPS = {
    **_ELEMENTWISE,
    "Cast": lambda i, a: i[0].to(_DTYPES[a["to"]]),
    "MatMul": lambda i, a: torch.matmul(i[0], i[1]),
    "Gemm": _gemm,
    "Conv": lambda i, a: _conv(i[0], i[1], i[2] if len(i) > 2 else None, a),
    "MaxPool": lambda i, a: _pool(i[0], a, "max"),
    "AveragePool": lambda i, a: _pool(i[0], a, "avg"),
    "GlobalAveragePool": lambda i, a: i[0].mean(
        dim=tuple(range(2, i[0].dim())), keepdim=True),
    "BatchNormalization": _bn,
    "Flatten": lambda i, a: i[0].reshape(
        math.prod(i[0].shape[:a.get("axis", 1)]), -1),
    "Reshape": lambda i, a: _reshape(i[0], _ints(i[1])),
    "Transpose": lambda i, a: i[0].permute(
        a.get("perm", list(reversed(range(i[0].dim()))))),
    "Unsqueeze": lambda i, a: _unsqueeze(i[0], _axes_of(i, a)),
    "Squeeze": lambda i, a: _squeeze(i[0], _axes_of(i, a)),
    "Expand": lambda i, a: _expand(i[0], _ints(i[1])),
    "Shape": lambda i, a: torch.tensor(list(i[0].shape), dtype=torch.int64,
                                       device=i[0].device),
    "Concat": lambda i, a: torch.cat(i, dim=a["axis"]),
    "Slice": lambda i, a: _slice(i[0], i),
    "Pad": lambda i, a: _pads(i[0], _ints(i[1]), float(i[2].item())
                              if len(i) > 2 and i[2] is not None else 0.0),
    "Gather": lambda i, a: torch.index_select(
        i[0], a.get("axis", 0) % i[0].dim(),
        i[1].reshape(-1).long()).reshape(
            tuple(i[0].shape[:a.get("axis", 0) % i[0].dim()])
            + tuple(i[1].shape)
            + tuple(i[0].shape[a.get("axis", 0) % i[0].dim() + 1:])),
    "ReduceSum": lambda i, a: _reduce(
        lambda x, d, k: x.sum(d, keepdim=k), i[0], a, i),
    "ReduceMean": lambda i, a: _reduce(
        lambda x, d, k: x.mean(d, keepdim=k), i[0], a, i),
    "ReduceMax": lambda i, a: _reduce(
        lambda x, d, k: x.amax(d, keepdim=k), i[0], a, i),
    "ReduceMin": lambda i, a: _reduce(
        lambda x, d, k: x.amin(d, keepdim=k), i[0], a, i),
    "ArgMax": lambda i, a: torch.argmax(i[0], dim=a.get("axis", 0),
                                        keepdim=bool(a.get("keepdims", 1))),
    "Softmax": lambda i, a: torch.softmax(i[0], dim=a.get("axis", -1)),
    "LogSoftmax": lambda i, a: torch.log_softmax(i[0],
                                                 dim=a.get("axis", -1)),
}


def _axes_of(ins, a):
    if len(ins) > 1 and ins[1] is not None:
        return _ints(ins[1])
    return list(a.get("axes", []))


def _unsqueeze(x, axes):
    rank = x.dim() + len(axes)
    for d in sorted(v % rank for v in axes):
        x = x.unsqueeze(d)
    return x


def _squeeze(x, axes):
    if not axes:
        return x.squeeze()
    for d in sorted((v % x.dim() for v in axes), reverse=True):
        x = x.squeeze(d)
    return x


def run(model: Model, inputs, device="cpu") -> List[torch.Tensor]:
    """The graph's outputs for ``inputs`` (arrays or tensors, in the
    graph's input order), computed on ``device``."""
    env: Dict[str, torch.Tensor] = {
        k: v.to(device) for k, v in model.initializers.items()}
    for (name, _elem, _dims), x in zip(model.inputs, inputs):
        env[name] = (x if isinstance(x, torch.Tensor)
                     else torch.from_numpy(np.asarray(x))).to(device)
    with torch.no_grad():
        for op, ins, outs, attrs in model.nodes:
            fn = _OPS.get(op)
            vals = [env[i] if i else None for i in ins]
            if op == "Split":
                res = _split(vals[0], vals, attrs, len(outs))
            elif fn is None:
                raise NotImplementedError(f"ONNX op {op!r} in the evaluator")
            else:
                res = fn(vals, attrs)
            res = res if isinstance(res, list) else [res]
            for o, r in zip(outs, res):
                env[o] = r
    return [env[name] for name, _e, _d in model.outputs]
