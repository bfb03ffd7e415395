"""The port's ONNX export (``paddle_tpu_torch.onnx``) against the JAX
package's, on the CPU.

- (a) ``_pb``'s encoders give the reference's bytes for the same values,
  negative ints included, and ``decode`` round-trips.
- (b) The layer walker: the MLP and LeNet cases of
  ``tests/test_onnx_export.py`` on both packages (the reference through
  its writers, the port through ``onnx.export``), on the same weights
  (``recipes.zoo_weights``). The two files are equal byte for byte but
  for ``ModelProto.producer_name`` (``paddle_tpu`` against
  ``paddle_tpu_torch``): the same op list, attributes, initializer dims
  and bit-equal payloads.
- (c) The trace converter: every trace case of the reference file runs on
  both packages (residual, checkpointed through
  ``distributed.fleet.utils.recompute``, mixed static/dynamic specs,
  dtype fidelity, the GPT block, the fallback; ResNet-50 marked ``slow``
  as the reference marks it), and every structural assertion it makes
  holds on the port's file. Each case's two files are run on the same
  input by ``paddle_tpu_torch/testdata/onnx_eval.py``: each equals its
  own package's forward within :data:`EVAL_TOL`, and the two agree
  within :data:`ACROSS_TOL` (rtol, and atol of the largest element). The
  reference's files against the JAX forward hold the evaluator itself.
- (d) The flash node: a narrow GPT at S 512 traced under
  ``flash_attention.exporting()`` holds the registered flash-forward op;
  its ONNX file holds no custom op, and its evaluation equals the plain
  forward.
"""
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as ref
from paddle_tpu import nn as rnn
from paddle_tpu.jit.functionalization import functional_call as \
    rfunctional_call
from paddle_tpu.jit.functionalization import state_of as rstate_of
from paddle_tpu.nn import initializer as rinit
from paddle_tpu.onnx import _pb as ref_pb
from paddle_tpu.static import InputSpec as RSpec

import paddle_tpu_torch as port
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.jit import InputSpec as PSpec
from paddle_tpu_torch.nn import initializer as pinit
from paddle_tpu_torch.onnx import _pb as port_pb
from paddle_tpu_torch.onnx import _trace_writer
from paddle_tpu_torch.ops import flash_attention
from paddle_tpu_torch.testdata import onnx_eval, recipes

from torch_threads import two_threads  # noqa: F401

EVAL_TOL = 1e-5     # a file against its own package's forward (float32)
ACROSS_TOL = 1e-5   # the reference's file against the port's


def _close(got, want, tol, msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape, msg)
    np.testing.assert_allclose(
        got, want, rtol=tol, atol=tol * max(1.0, np.abs(want).max()),
        err_msg=msg)


def _decode(path):
    with open(path, "rb") as f:
        buf = f.read()
    model = port_pb.decode(buf)
    assert model[1][0] == 8
    graph = port_pb.decode(model[7][0])
    nodes = [port_pb.decode(n) for n in graph.get(1, [])]
    inits = [port_pb.decode(t) for t in graph.get(5, [])]
    return model, graph, nodes, inits


def _ops(path):
    return onnx_eval.op_types(onnx_eval.load(path))


def _io(path):
    m = onnx_eval.load(path)
    return m.inputs, m.outputs


def _constant_built(init, fn):
    init.set_global_initializer(init.Constant(0.0), init.Constant(0.0))
    try:
        return fn()
    finally:
        init.set_global_initializer(None)


def _carry(rm, pm, recipe=recipes.zoo_weights, *args):
    """The recipe's weights into both models (names and shapes 1:1)."""
    names_shapes = [(n, tuple(int(s) for s in v.shape))
                    for n, v in rm.state_dict().items()]
    assert [(n, tuple(t.shape)) for n, t in pm.named_state().items()] == \
        names_shapes
    w = recipe(names_shapes, 0, *args)
    rm.set_state_dict({k: jnp.asarray(v) for k, v in w.items()})
    pm.set_state_dict_from_numpy(w)
    return w


def _ref_onnx(rm, path, rspecs):
    """``paddle_tpu.onnx.export``'s two writers in its order, without the
    StableHLO export in front of them (seconds a model here; the fallback
    case runs the whole entry point)."""
    from paddle_tpu.onnx._trace_writer import export_traced_layer
    from paddle_tpu.onnx._writer import export_layer_to_onnx
    try:
        return export_layer_to_onnx(rm, path, input_spec=rspecs)
    except NotImplementedError:
        return export_traced_layer(rm, path, rspecs)


def _export_both(tmp_path, rm, pm, stem, rspecs, pspecs):
    rm.eval()
    pm.eval()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rout = _ref_onnx(rm, str(tmp_path / f"ref_{stem}.onnx"), rspecs)
        pout = port.onnx.export(pm, str(tmp_path / f"port_{stem}.onnx"),
                                input_spec=pspecs)
    assert rout.endswith(".onnx") and pout.endswith(".onnx"), (rout, pout)
    return rout, pout


def _hold(rout, pout, rm, pm, inputs):
    """Each file on ``inputs`` equals its package's forward; the two
    agree."""
    with torch.no_grad():
        pwant = pm(*[torch.from_numpy(x) for x in inputs]).numpy()
    # the reference's forward jitted whole: its eager op-by-op dispatch
    # costs seconds a model here
    params, buffers = rstate_of(rm)
    rwant = np.asarray(jax.jit(
        lambda p, b, *xs: rfunctional_call(rm, p, b, *xs)[0])(
            params, buffers, *[jnp.asarray(x) for x in inputs]))
    rgot = onnx_eval.run(onnx_eval.load(rout), inputs)[0].numpy()
    pgot = onnx_eval.run(onnx_eval.load(pout), inputs)[0].numpy()
    _close(rgot, rwant, EVAL_TOL, "reference file vs JAX forward")
    _close(pgot, pwant, EVAL_TOL, "port file vs the port's forward")
    _close(pgot, rgot, ACROSS_TOL, "port file vs reference file")


# -- (a) protobuf ---------------------------------------------------------------

PB_CASES = [
    ("varint", (0,)), ("varint", (1,)), ("varint", (300,)),
    ("varint", (2 ** 63 - 1,)), ("varint", (-1,)), ("varint", (-13,)),
    ("tag", (7, 2)), ("f_varint", (3, -5)), ("f_bytes", (9, b"\x00\xff")),
    ("f_str", (2, "paddle_tpu_graph")),
    ("f_packed_i64", (4, [0, -1, 1 << 40])),
    ("f_packed_f32", (4, [0.5, -2.25, 1e-30])),
]


@pytest.mark.parametrize("fn,args", PB_CASES,
                         ids=[f"{f}{i}" for i, (f, _) in enumerate(PB_CASES)])
def test_pb_encoders_give_the_reference_bytes(fn, args):
    got = getattr(port_pb, fn)(*args)
    assert got == getattr(ref_pb, fn)(*args)


def test_pb_decode_round_trips():
    msg = (port_pb.f_varint(1, 8) + port_pb.f_str(2, "x")
           + port_pb.f_bytes(7, port_pb.f_varint(3, -2))
           + port_pb.f_varint(5, 1 << 35))
    d = port_pb.decode(msg)
    assert d[1] == [8] and d[2] == [b"x"] and d[5] == [1 << 35]
    assert port_pb.decode(d[7][0])[3] == [(1 << 64) - 2]
    assert d == ref_pb.decode(msg)


# -- (b) the layer walker -----------------------------------------------------

def _walker_pair(name):
    if name == "mlp":
        def build(n):
            return n.Sequential(n.Linear(4, 8), n.ReLU(), n.Linear(8, 2),
                                n.Softmax())
        rm, pm = build(rnn), build(pnn)
        return rm, pm, [None, 4], 3
    from paddle_tpu.vision.models import LeNet as RLeNet
    from paddle_tpu_torch.vision.models import LeNet as PLeNet
    rm = _constant_built(rinit, RLeNet)
    pm = _constant_built(pinit, PLeNet)
    return rm, pm, [None, 1, 28, 28], 2


@pytest.mark.parametrize("name", ["mlp", "lenet"])
def test_layer_walker_matches_the_reference(tmp_path, name):
    rm, pm, shape, batch = _walker_pair(name)
    _carry(rm, pm)
    rout, pout = _export_both(tmp_path, rm, pm, name,
                              [RSpec(shape, "float32")],
                              [PSpec(shape, "float32")])
    rmodel, rgraph, _, _ = _decode(rout)
    pmodel, pgraph, pnodes, pinits = _decode(pout)
    # byte for byte but the producer's name
    assert rmodel[2] == [b"paddle_tpu"]
    assert pmodel[2] == [b"paddle_tpu_torch"]
    assert {k: v for k, v in pmodel.items() if k != 2} == \
        {k: v for k, v in rmodel.items() if k != 2}
    ops = _ops(pout)
    if name == "mlp":
        assert ops == ["Gemm", "Relu", "Gemm", "Softmax", "Identity"]
        dims = sorted(tuple(t.get(1, [])) for t in pinits)
        assert (4, 8) in dims and (8, 2) in dims
        w0 = pm[0].weight.detach().numpy()
        blobs = [np.frombuffer(t[9][0], dtype=np.float32) for t in pinits]
        assert any(b.size == w0.size and
                   np.array_equal(b.reshape(w0.shape), w0) for b in blobs)
    else:
        assert ops.count("Conv") == 2 and ops.count("MaxPool") == 2
        assert ops.count("Gemm") == 3 and "Flatten" in ops
        assert port_pb.decode(pgraph[11][0])[1][0] == b"input"
    x = np.random.RandomState(1).randn(batch, *shape[1:]).astype(np.float32)
    _hold(rout, pout, rm, pm, [x])


# -- (c) the trace converter --------------------------------------------------

def _residual(n):
    class Residual(n.Layer):
        def __init__(self):
            super().__init__()
            self.fc = n.Linear(4, 4)

        def forward(self, x):
            return x + self.fc(x)
    return Residual()


def test_trace_residual(tmp_path):
    rm, pm = _residual(rnn), _residual(pnn)
    _carry(rm, pm)
    rout, pout = _export_both(tmp_path, rm, pm, "res",
                              [RSpec([2, 4], "float32")],
                              [PSpec([2, 4], "float32")])
    ops = _ops(pout)
    assert "MatMul" in ops and "Add" in ops
    _, _, _, inits = _decode(pout)
    w = pm.fc.weight.detach().numpy()
    blobs = [np.frombuffer(t[9][0], dtype=np.float32) for t in inits
             if t.get(9)]
    assert any(b.size == w.size and np.array_equal(b.reshape(w.shape), w)
               for b in blobs)
    x = np.random.RandomState(2).randn(2, 4).astype(np.float32)
    _hold(rout, pout, rm, pm, [x])


def test_trace_checkpointed(tmp_path):
    import jax
    from paddle_tpu_torch.distributed.fleet.utils import recompute

    class RRemat(rnn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = rnn.Linear(4, 4)

        def forward(self, x):
            return jax.checkpoint(lambda v: self.fc(v) + v)(x)

    class PRemat(pnn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = pnn.Linear(4, 4)

        def forward(self, x):
            return recompute(lambda v: self.fc(v) + v, x)

    rm, pm = RRemat(), PRemat()
    _carry(rm, pm)
    rout, pout = _export_both(tmp_path, rm, pm, "remat",
                              [RSpec([2, 4], "float32")],
                              [PSpec([2, 4], "float32")])
    ops = _ops(pout)
    assert "MatMul" in ops and "Add" in ops
    x = np.random.RandomState(3).randn(2, 4).astype(np.float32)
    _hold(rout, pout, rm, pm, [x])


def test_trace_mixed_static_dynamic_specs(tmp_path):
    class RTwo(rnn.Layer):
        def forward(self, x, y):
            return x + jnp.sum(y, axis=0)

    class PTwo(pnn.Layer):
        def forward(self, x, y):
            return x + torch.sum(y, dim=0)

    rm, pm = RTwo(), PTwo()
    rout, pout = _export_both(
        tmp_path, rm, pm, "two",
        [RSpec([None, 4], "float32"), RSpec([13, 4], "float32")],
        [PSpec([None, 4], "float32"), PSpec([13, 4], "float32")])
    ins, outs = _io(pout)
    assert isinstance(ins[0][2][0], str)    # dynamic batch
    assert ins[1][2] == [13, 4]             # static spec stays literal
    assert isinstance(outs[0][2][0], str)
    rs = np.random.RandomState(4)
    x = rs.randn(5, 4).astype(np.float32)   # a batch other than traced
    y = rs.randn(13, 4).astype(np.float32)
    _hold(rout, pout, rm, pm, [x, y])


def _emb(n):
    class Emb(n.Layer):
        def __init__(self):
            super().__init__()
            self.emb = n.Embedding(16, 8)
            self.fc = n.Linear(8, 4)

        def forward(self, ids):
            return self.fc(self.emb(ids))
    return Emb()


def test_trace_dtype_fidelity(tmp_path):
    rm, pm = _emb(rnn), _emb(pnn)
    _carry(rm, pm)
    rout, pout = _export_both(tmp_path, rm, pm, "emb",
                              [RSpec([2, 4], "int32")],
                              [PSpec([2, 4], "int32")])
    ins, outs = _io(pout)
    assert ins[0][1] == 6        # INT32 preserved, not widened to 7
    assert outs[0][1] == 1       # FLOAT out
    ids = np.random.RandomState(5).randint(0, 16, (2, 4)).astype(np.int32)
    _hold(rout, pout, rm, pm, [ids])
    # bf16 params export as FLOAT (the policy), not a new dtype
    r2, p2 = rnn.Sequential(rnn.Linear(4, 2)), pnn.Sequential(pnn.Linear(4, 2))
    _carry(r2, p2)
    r2.bfloat16()
    p2.bfloat16()
    rout2, pout2 = _export_both(tmp_path, r2, p2, "bf",
                                [RSpec([1, 4], "float32")],
                                [PSpec([1, 4], "float32")])
    _, _, _, inits = _decode(pout2)
    assert all(t[2][0] in (1, 7) for t in inits)   # FLOAT/INT64 only
    # the same bf16 weights widened: the two files' graphs are equal
    assert _decode(pout2)[0][7] == _decode(rout2)[0][7]


def _gpt_pair(seq, hidden=32, heads=2):
    from paddle_tpu.text.models import GPTModel as RGPT
    from paddle_tpu_torch.text.models import GPTModel as PGPT
    cfg = dict(tensor_parallel=False, vocab_size=128, hidden_size=hidden,
               num_layers=1, num_heads=heads, max_position_embeddings=seq,
               attn_dropout=0.0, hidden_dropout=0.0)
    rm = _constant_built(rinit, lambda: RGPT(**cfg))
    pm = _constant_built(pinit, lambda: PGPT(**cfg))
    _carry(rm, pm, recipes.bert_weights, 0.02)
    return rm, pm


def test_trace_gpt_block(tmp_path):
    rm, pm = _gpt_pair(16)
    rout, pout = _export_both(tmp_path, rm, pm, "gpt",
                              [RSpec([1, 16], "int32")],
                              [PSpec([1, 16], "int32")])
    ops = _ops(pout)
    assert "MatMul" in ops and "Gather" in ops and "Where" in ops
    assert "Tanh" in ops  # gelu tanh form inside the block
    ids = np.random.RandomState(6).randint(0, 128, (1, 16)).astype(np.int32)
    _hold(rout, pout, rm, pm, [ids])


def _sorty(n, sort):
    class Sorty(n.Layer):
        def forward(self, x):
            return sort(x)
    return Sorty()


def test_trace_fallback_warns(tmp_path):
    rm = _sorty(rnn, lambda x: jnp.sort(x, axis=-1))
    pm = _sorty(pnn, lambda x: torch.sort(x, dim=-1)[0])
    with pytest.warns(UserWarning, match="ONNX conversion not available"):
        rprefix = ref.onnx.export(rm, str(tmp_path / "rsrt.onnx"),
                                  input_spec=[RSpec([2, 4], "float32")])
    with pytest.warns(UserWarning, match="ONNX conversion not available"):
        prefix = port.onnx.export(pm, str(tmp_path / "psrt.onnx"),
                                  input_spec=[PSpec([2, 4], "float32")])
    assert not prefix.endswith(".onnx") and not rprefix.endswith(".onnx")
    assert os.path.exists(rprefix + ".stablehlo")
    assert os.path.exists(prefix + ".pt2")
    assert os.path.exists(prefix + ".pdiparams")
    x = np.random.RandomState(7).randn(2, 4).astype(np.float32)
    got = port.jit.load(prefix, device="cpu")(x)
    _close(got.numpy(), np.sort(x, axis=-1), 0.0)


@pytest.mark.slow
def test_trace_resnet50(tmp_path):
    from paddle_tpu.vision.models import resnet50 as rresnet
    from paddle_tpu_torch.vision.models import resnet50 as presnet
    rm = _constant_built(rinit, rresnet)
    pm = _constant_built(pinit, presnet)
    _carry(rm, pm, recipes.resnet_weights, 0.05, 0.01)
    rout, pout = _export_both(tmp_path, rm, pm, "r50",
                              [RSpec([None, 3, 64, 64], "float32")],
                              [PSpec([None, 3, 64, 64], "float32")])
    ops = _ops(pout)
    assert ops.count("Conv") == 53
    assert "MaxPool" in ops and "MatMul" in ops
    assert os.path.getsize(pout) > 90e6
    ins, outs = _io(pout)
    assert ins[0][1] == 1 and isinstance(ins[0][2][0], str)
    assert ins[0][2][1:] == [3, 64, 64]
    assert isinstance(outs[0][2][0], str)
    _, _, _, inits = _decode(pout)
    shape_inits = [np.frombuffer(t[9][0], np.int64) for t in inits
                   if t[2][0] == 7 and len(t.get(1, [])) == 1]
    assert any(s.size >= 2 and s[0] == 0 for s in shape_inits)
    x = recipes.resnet_data(1, 2, 64)[0]
    _hold(rout, pout, rm, pm, [x])


# -- (d) the flash node ----------------------------------------------------------

def test_flash_node_maps_to_its_plain_subgraph(tmp_path):
    """H 128 over 2 heads (head dim 64, one the flash gate takes), S 512."""
    from paddle_tpu_torch.jit.functionalization import functional_call, \
        state_of
    _, pm = _gpt_pair(512, hidden=128, heads=2)
    pm.eval()
    ids = np.random.RandomState(8).randint(0, 128, (1, 512)).astype(np.int32)
    params, buffers = state_of(pm)

    def fn(p, b, x):
        return functional_call(pm, p, b, x)[0]

    with flash_attention.exporting():
        g = _trace_writer.trace_graph(fn, (dict(params), dict(buffers),
                                           torch.from_numpy(ids)))
    names = [_trace_writer.op_name(n.target) for n in g.graph.nodes
             if n.op == "call_function"]
    assert names.count(_trace_writer.FLASH_OP) == 1
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = port.onnx.export(pm, str(tmp_path / "flash.onnx"),
                               input_spec=[PSpec([1, 512], "int32")])
    assert out.endswith(".onnx")
    ops = _ops(out)
    assert all(op[0].isupper() and "::" not in op for op in ops)
    assert "Softmax" in ops and "Where" in ops
    with torch.no_grad():
        want = pm(torch.from_numpy(ids)).numpy()     # the plain path here
    got = onnx_eval.run(onnx_eval.load(out), [ids])[0].numpy()
    _close(got, want, EVAL_TOL, "flash subgraph vs the plain forward")


def test_other_kernel_ops_have_no_mapping():
    conv = _trace_writer._Converter()

    class Node:
        target = flash_attention.FLASH_DQ_OP.default
        users = {1: None}
        args = ()
        kwargs = {}

    with pytest.raises(NotImplementedError, match="has no ONNX mapping"):
        conv.call(Node())
