"""Layer-graph -> ONNX ModelProto converter (wire format, no dependency).

Port of ``paddle_tpu/onnx/_writer.py``: the layer walker. It turns the
feed-forward layer graphs of the model zoo's CNN/MLP family (LeNet,
VGG-style stacks, MLPs), ``Sequential``-like containers of the port's
``Linear`` / ``Conv2D`` / pooling / activation / norm / ``Flatten`` /
dropout layers, into ONNX nodes, as the reference does. The port's
``Linear`` keeps the reference's ``(in, out)`` weight, so a ``Gemm``
initializer holds the weight's bytes unchanged. Anything the walker
cannot express raises NotImplementedError, and ``onnx.export`` tries the
trace converter (``_trace_writer.py``) next.

ONNX field numbers per onnx/onnx.proto; see _pb.py.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from . import _pb

#: ModelProto.producer_name: the one field whose bytes differ from the
#: reference's file for the same layers and weights
PRODUCER = "paddle_tpu_torch"

# TensorProto.DataType
FLOAT, INT64 = 1, 7

# AttributeProto.AttributeType
ATTR_FLOAT, ATTR_INT, ATTR_INTS = 1, 2, 7


def _attr(name: str, value) -> bytes:
    body = _pb.f_str(1, name)
    if isinstance(value, float):
        body += _pb.tag(2, 5) + __import__("struct").pack("<f", value)
        body += _pb.f_varint(20, ATTR_FLOAT)
    elif isinstance(value, int):
        body += _pb.f_varint(3, value)
        body += _pb.f_varint(20, ATTR_INT)
    elif isinstance(value, (list, tuple)):
        for v in value:
            body += _pb.f_varint(8, int(v))
        body += _pb.f_varint(20, ATTR_INTS)
    else:
        raise TypeError(f"unsupported attr {name}={value!r}")
    return body


def _node(op_type: str, inputs: List[str], outputs: List[str],
          name: str = "", attrs: Optional[dict] = None) -> bytes:
    body = b"".join(_pb.f_str(1, i) for i in inputs)
    body += b"".join(_pb.f_str(2, o) for o in outputs)
    if name:
        body += _pb.f_str(3, name)
    body += _pb.f_str(4, op_type)
    for k, v in (attrs or {}).items():
        body += _pb.f_bytes(5, _attr(k, v))
    return body


# ONNX TensorProto.DataType enums for the exact-dtype policy: integer
# widths are preserved (an int32-ids model must load with int32 inputs —
# widening to i64 broke consumers), floats keep their width, and bf16 is
# exported as FLOAT (documented: every bf16 value is exactly
# representable in f32, and runtime BFLOAT16 kernel coverage is patchy).
_NP_TO_ONNX = {
    np.dtype(np.float32): 1, np.dtype(np.uint8): 2, np.dtype(np.int8): 3,
    np.dtype(np.uint16): 4, np.dtype(np.int16): 5, np.dtype(np.int32): 6,
    np.dtype(np.int64): 7, np.dtype(np.bool_): 9,
    np.dtype(np.float16): 10, np.dtype(np.float64): 11,
    np.dtype(np.uint32): 12, np.dtype(np.uint64): 13,
}


def _np_onnx_dtype(arr: np.ndarray):
    """(storage array, onnx enum) under the exact-dtype policy."""
    if str(arr.dtype) == "bfloat16":
        return arr.astype(np.float32), 1
    dt = _NP_TO_ONNX.get(arr.dtype)
    if dt is None:
        raise NotImplementedError(f"dtype {arr.dtype} in ONNX export")
    return arr, dt


def _tensor(name: str, arr) -> bytes:
    arr, dt = _np_onnx_dtype(_np(arr))
    body = b"".join(_pb.f_varint(1, int(d)) for d in arr.shape)
    body += _pb.f_varint(2, dt)
    body += _pb.f_str(8, name)
    data = np.ascontiguousarray(arr)
    if dt == 9:  # BOOL raw_data is one byte per element
        data = data.astype(np.uint8)
    body += _pb.f_bytes(9, data.tobytes())
    return body


def _value_info(name: str, shape, elem_type: int = FLOAT) -> bytes:
    dims = b""
    for d in shape:
        if d is None or (isinstance(d, int) and d < 0):
            dim = _pb.f_str(2, "N")  # dim_param (dynamic batch)
        else:
            dim = _pb.f_varint(1, int(d))
        dims += _pb.f_bytes(1, dim)
    tensor_type = _pb.f_varint(1, elem_type) + _pb.f_bytes(2, dims)
    type_proto = _pb.f_bytes(1, tensor_type)
    return _pb.f_str(1, name) + _pb.f_bytes(2, type_proto)


def _model(graph: bytes, opset_version: int) -> bytes:
    opset = _pb.f_str(1, "") + _pb.f_varint(2, opset_version)
    return (_pb.f_varint(1, 8)                      # ir_version = 8
            + _pb.f_str(2, PRODUCER)                # producer_name
            + _pb.f_bytes(7, graph)
            + _pb.f_bytes(8, opset))


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _pads4(padding):
    """paddle padding -> ONNX pads [t, l, b, r]."""
    if isinstance(padding, int):
        return [padding] * 4
    p = list(padding)
    if len(p) == 2:                     # (ph, pw)
        return [p[0], p[1], p[0], p[1]]
    if len(p) == 4:                     # (t, b, l, r) paddle order
        return [p[0], p[2], p[1], p[3]]
    raise NotImplementedError(f"padding {padding!r}")


class _GraphBuilder:
    def __init__(self):
        self.nodes: List[bytes] = []
        self.initializers: List[bytes] = []
        self.counter = 0

    def fresh(self, hint: str) -> str:
        self.counter += 1
        return f"{hint}_{self.counter}"

    def add_init(self, hint: str, arr) -> str:
        name = self.fresh(hint)
        self.initializers.append(_tensor(name, arr))
        return name

    def add_node(self, op_type, inputs, outputs, attrs=None):
        self.nodes.append(_node(op_type, inputs, outputs,
                                name=self.fresh(op_type.lower()),
                                attrs=attrs))


# Non-container zoo models whose forward is verified to be a plain
# sequential composition of their registered sublayers (+auto-flatten
# before Linear). Models with skip connections (ResNet, MobileNetV2) must
# NOT be added here — a child-walk would silently drop the residual adds.
_SEQUENTIAL_SAFE = {"LeNet"}


def _flatten_layers(layer):
    """Yield the execution-ordered leaf layers of Sequential-style models."""
    from ..nn.layers.container import LayerList, Sequential
    if isinstance(layer, (Sequential, LayerList)):
        for sub in layer:
            yield from _flatten_layers(sub)
        return
    subs = list(layer.children()) if hasattr(layer, "children") else []
    if not subs:
        yield layer
        return
    if type(layer).__name__ in _SEQUENTIAL_SAFE:
        for sub in subs:
            yield from _flatten_layers(sub)
        return
    raise NotImplementedError(
        f"layer {type(layer).__name__} has sublayers with a custom forward; "
        "only Sequential-style compositions are convertible")


_SIMPLE_ACTS = {
    "ReLU": "Relu", "Sigmoid": "Sigmoid", "Tanh": "Tanh", "ELU": "Elu",
    "Softplus": "Softplus", "Softsign": "Softsign", "SELU": "Selu",
    "Identity": "Identity",
}


def _np(v):
    """A parameter or buffer as a host array (bfloat16 as float32: every
    bfloat16 value is exact in float32, the exact-dtype policy)."""
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.cpu().numpy()
    return np.asarray(v)


def _convert_layer(g: _GraphBuilder, layer, cur: str) -> str:
    """Append nodes for `layer`, consuming tensor `cur`; return output name."""
    cls = type(layer).__name__
    if cls in _SIMPLE_ACTS:
        kwargs = dict(getattr(layer, "_kwargs", {}) or {})
        attrs = None
        if cls == "ELU" and set(kwargs) <= {"alpha"}:
            attrs = {"alpha": float(kwargs.get("alpha", 1.0))}
            kwargs.pop("alpha", None)
        if kwargs:
            # e.g. GELU(approximate=True), Softplus(beta=...): the bare ONNX
            # node would silently compute a different function
            raise NotImplementedError(
                f"{cls} with kwargs {sorted(kwargs)} has no exact ONNX "
                "equivalent")
        out = g.fresh("act")
        g.add_node(_SIMPLE_ACTS[cls], [cur], [out], attrs)
        return out
    if cls == "LeakyReLU":
        out = g.fresh("leaky")
        g.add_node("LeakyRelu", [cur], [out],
                   {"alpha": float(layer.negative_slope)})
        return out
    if cls == "GELU":
        if getattr(layer, "_kwargs", {}).get("approximate"):
            raise NotImplementedError(
                "GELU(approximate=True) (tanh form) has no exact ONNX "
                "expansion here; only the erf form is emitted")
        # opset<20 has no Gelu: x * 0.5 * (1 + erf(x/sqrt(2)))
        s = g.add_init("gelu_scale", np.float32(1.0 / np.sqrt(2.0)))
        half = g.add_init("gelu_half", np.float32(0.5))
        one = g.add_init("gelu_one", np.float32(1.0))
        t1, t2, t3, t4, out = (g.fresh("gelu") for _ in range(5))
        g.add_node("Mul", [cur, s], [t1])
        g.add_node("Erf", [t1], [t2])
        g.add_node("Add", [t2, one], [t3])
        g.add_node("Mul", [t3, half], [t4])
        g.add_node("Mul", [cur, t4], [out])
        return out
    if cls == "Softmax":
        out = g.fresh("softmax")
        g.add_node("Softmax", [cur], [out],
                   {"axis": int(getattr(layer, "axis", -1))})
        return out
    if cls in ("Dropout", "Dropout2D", "Dropout3D", "AlphaDropout"):
        return cur  # inference export: dropout is identity
    if cls == "Flatten":
        if layer.start_axis != 1 or layer.stop_axis not in (-1, 3):
            raise NotImplementedError("Flatten with non-default axes")
        out = g.fresh("flat")
        g.add_node("Flatten", [cur], [out], {"axis": 1})
        return out
    if cls == "Linear":
        w = g.add_init("weight", _np(layer.weight))
        ins = [cur, w]
        if layer.bias is not None:
            ins.append(g.add_init("bias", _np(layer.bias)))
        out = g.fresh("gemm")
        g.add_node("Gemm", ins, [out], {"alpha": 1.0, "beta": 1.0,
                                        "transA": 0, "transB": 0})
        return out
    if cls == "Conv2D":
        if layer.data_format != "NCHW":
            raise NotImplementedError("ONNX Conv requires NCHW")
        w = g.add_init("conv_w", _np(layer.weight))
        ins = [cur, w]
        if layer.bias is not None:
            ins.append(g.add_init("conv_b", _np(layer.bias)))
        out = g.fresh("conv")
        g.add_node("Conv", ins, [out], {
            "kernel_shape": list(layer.kernel_size),
            "strides": list(_pair(layer.stride)),
            "pads": _pads4(layer.padding),
            "dilations": list(_pair(layer.dilation)),
            "group": int(layer.groups)})
        return out
    if cls in ("MaxPool2D", "AvgPool2D"):
        if layer._kw.get("ceil_mode"):
            raise NotImplementedError(f"{cls} with ceil_mode=True")
        if layer._kw.get("data_format", "NCHW") != "NCHW":
            raise NotImplementedError("ONNX pooling requires NCHW")
        out = g.fresh("pool")
        k = _pair(layer.kernel_size)
        s = _pair(layer.stride if layer.stride is not None
                  else layer.kernel_size)
        attrs = {"kernel_shape": list(k), "strides": list(s),
                 "pads": _pads4(layer.padding)}
        if cls == "AvgPool2D":
            attrs["count_include_pad"] = 0 if layer._kw.get(
                "exclusive", True) else 1
        g.add_node("MaxPool" if cls == "MaxPool2D" else "AveragePool",
                   [cur], [out], attrs)
        return out
    if cls == "AdaptiveAvgPool2D":
        if tuple(np.atleast_1d(layer.output_size)) not in ((1,), (1, 1)):
            raise NotImplementedError("AdaptiveAvgPool2D only to (1,1)")
        out = g.fresh("gap")
        g.add_node("GlobalAveragePool", [cur], [out])
        return out
    if cls in ("BatchNorm2D", "BatchNorm1D", "BatchNorm"):
        n = layer.num_features
        scale = g.add_init("bn_scale", _np(layer.weight)
                           if layer.weight is not None else np.ones(n, "f"))
        bias = g.add_init("bn_bias", _np(layer.bias)
                          if layer.bias is not None else np.zeros(n, "f"))
        mean = g.add_init("bn_mean", _np(layer._mean))
        var = g.add_init("bn_var", _np(layer._variance))
        out = g.fresh("bn")
        g.add_node("BatchNormalization", [cur, scale, bias, mean, var],
                   [out], {"epsilon": float(layer.epsilon)})
        return out
    raise NotImplementedError(f"no ONNX converter for layer {cls}")


def _out_shape(layer, in_shape):
    """Output shape from one forward on zeros (batch kept dynamic if it
    was): float32 zeros as the reference's, else zeros in the layer's own
    dtype (a float32 input does not multiply a bfloat16 weight in torch,
    where jnp promotes)."""
    concrete = [1 if (d is None or d < 0) else int(d) for d in in_shape]
    dtypes = [torch.float32]
    for p in layer.parameters():
        if p.dtype != torch.float32:
            dtypes.append(p.dtype)
        break
    for dtype in dtypes:
        try:
            p = next(iter(layer.parameters()), None)
            dev = p.device if p is not None else "cpu"
            with torch.no_grad():
                out = layer(torch.zeros(concrete, dtype=dtype, device=dev))
            shape = list(out.shape)
            if in_shape and (in_shape[0] is None or in_shape[0] < 0):
                shape[0] = None
            return shape
        except Exception:
            continue
    return [None]


def export_layer_to_onnx(layer, path: str, input_spec=None,
                         opset_version: int = 13) -> str:
    """Convert a Sequential-style Layer into an ONNX file at `path`."""
    if input_spec is None:
        raise NotImplementedError("onnx export requires input_spec")
    spec = input_spec[0] if isinstance(input_spec, (list, tuple)) else input_spec
    shape = list(getattr(spec, "shape", spec))
    g = _GraphBuilder()
    cur = "input"
    rank = len(shape)
    # Auto-inserting Flatten before Linear is only known-correct for the
    # whitelisted zoo models (their forward really flattens there). A plain
    # Sequential applying Linear to a rank>2 tensor maps over the LAST dim
    # (F.linear), which Gemm-after-Flatten would NOT compute — refuse and
    # fall back rather than emit a different function.
    allow_autoflatten = type(layer).__name__ in _SEQUENTIAL_SAFE
    for leaf in _flatten_layers(layer):
        if type(leaf).__name__ == "Linear" and rank > 2:
            if not allow_autoflatten:
                raise NotImplementedError(
                    "Linear on a rank>2 tensor (last-dim matmul) has no "
                    "Gemm equivalent without an explicit Flatten layer")
            flat = g.fresh("autoflat")
            g.add_node("Flatten", [cur], [flat], {"axis": 1})
            cur, rank = flat, 2
        cur = _convert_layer(g, leaf, cur)
        if type(leaf).__name__ == "Flatten":
            rank = 2
    out_name = g.fresh("output")
    g.add_node("Identity", [cur], [out_name])
    graph = b"".join(_pb.f_bytes(1, n) for n in g.nodes)
    graph += _pb.f_str(2, "paddle_tpu_graph")
    graph += b"".join(_pb.f_bytes(5, t) for t in g.initializers)
    graph += _pb.f_bytes(11, _value_info("input", shape))
    graph += _pb.f_bytes(12, _value_info(out_name, _out_shape(layer, shape)))
    model = _model(graph, opset_version)
    with open(path, "wb") as f:
        f.write(model)
    return path
