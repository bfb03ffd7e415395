"""The port's Megatron layers at ``{"model": 2}`` and ``{"model": 4}`` over
gloo ranks on the CPU, against the JAX package's layers under
``shard_map`` (their explicit-collective branch) and against the dense
layer on the whole weights.

The port ``spawn``s a world of 2 and one of 4 (``torch_hybrid_worker.py``,
each once, every case inside it); each rank loads its piece of the
reference's whole weights (``Layer.set_state_dict_from_numpy``). Per case:
the forward output, the gradient of ``sum(out * r)`` (``r`` fixed random)
with respect to the input and to each weight, put together over the ranks
by each tensor's split. The reference computes the same per device inside
``shard_map`` (as its trainer does) and the dense layer with ``jax.grad``.

- ``ColumnParallelLinear`` with and without ``gather_output``,
  ``RowParallelLinear`` with and without ``input_is_parallel``,
  ``VocabParallelEmbedding`` (ids on every rank's range and outside it),
  ``ParallelCrossEntropy`` (labels on every rank's range);
- the reference's ``gather_output=True`` gradients are ``n`` times the
  dense layer's (``lax.all_gather``'s transpose sums the replicated
  cotangent): the port's match the dense layer, the reference's divided
  by ``n`` (ROADMAP Queue 3);
- the gradient scale: the row layer (its input split) built on a plain
  all-reduce whose backward all-reduces again (as
  ``torch.distributed.nn.functional.all_reduce``'s) gives ``n`` times the
  dense gradients, which the port's layers (``reduce_from_parallel_region``:
  identity backward) do not.

Tolerance 1e-5 absolute on values of order 1 (float32 on both sides; the
dot products of 16 to 64 terms and the model-axis sums run in other
orders, a few ulps each); the factor of the scale test is exact up to the
same bar.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

import paddle_tpu as paddle
from paddle_tpu.distributed.meta_parallel import (ColumnParallelLinear,
                                                  ParallelCrossEntropy,
                                                  RowParallelLinear,
                                                  VocabParallelEmbedding)
from paddle_tpu.jit.functionalization import functional_call, state_of
from paddle_tpu.nn import functional as rF

import torch_hybrid_worker as worker
from torch_threads import two_threads  # noqa: F401

pytestmark = pytest.mark.multihost(timeout=300)

ATOL = 1e-5


def _layer(kind, case):
    paddle.seed(11)
    if kind == "column":
        return ColumnParallelLinear(*case["dims"],
                                    gather_output=case["gather"])
    if kind == "row":
        return RowParallelLinear(*case["dims"],
                                 input_is_parallel=case["parallel_in"])
    if kind == "embedding":
        return VocabParallelEmbedding(*case["dims"])
    return ParallelCrossEntropy()


def _cases(n):
    rs = np.random.RandomState(20 + n)
    c = {
        "column-gather": dict(layer="column", dims=(16, 32), gather=True,
                              x=rs.randn(4, 16), r=rs.randn(4, 32)),
        "column-split": dict(layer="column", dims=(16, 32), gather=False,
                             x=rs.randn(4, 16), r=rs.randn(4, 32),
                             out_spec=(None, "model")),
        "row-parallel-in": dict(layer="row", dims=(32, 8), parallel_in=True,
                                x=rs.randn(4, 32), r=rs.randn(4, 8),
                                x_spec=(None, "model")),
        "row-whole-in": dict(layer="row", dims=(32, 8), parallel_in=False,
                             x=rs.randn(4, 32), r=rs.randn(4, 8)),
        "embedding": dict(layer="embedding", dims=(64, 16),
                          x=rs.randint(0, 64, (4, 7)),
                          r=rs.randn(4, 7, 16)),
        "ce": dict(layer="ce", x=rs.randn(6, 64) * 3,
                   label=rs.randint(0, 64, (6,)), r=rs.randn(6)),
    }
    for case in c.values():
        case["n"] = n
        for k in ("x", "r"):
            if case[k].dtype == np.float64:
                case[k] = case[k].astype(np.float32)
        if case["layer"] != "ce":
            case["weights"] = {k: np.asarray(v) for k, v in
                               _layer(case["layer"], case)
                               .state_dict().items()}
    return c


CASES = {n: _cases(n) for n in (2, 4)}
_RUNS = {}


def _world(n, tmp_path_factory):
    if n not in _RUNS:
        _RUNS[n] = worker.spawn_plan({"mp": CASES[n]}, n, tmp_path_factory,
                                     f"mp{n}")
    return _RUNS[n]


def _join(parts, spec):
    """The ranks' pieces of one tensor put together along its ``model``
    dim (``spec``), or the one whole copy they all hold."""
    spec = tuple(spec or ())
    if "model" in spec:
        return np.concatenate(parts, axis=spec.index("model"))
    for p in parts[1:]:
        np.testing.assert_array_equal(p, parts[0])
    return parts[0]


def _specs(case):
    """(x spec, out spec, [grad specs in the worker's order])."""
    kind = case["layer"]
    xs = case.get("x_spec")
    if kind == "column":
        return xs, case.get("out_spec"), [xs, (None, "model"), ("model",)]
    if kind == "row":
        return xs, None, [xs, ("model", None), None]
    if kind == "embedding":
        return None, None, [("model", None)]
    return None, None, [(None, "model")]


def _ref(case):
    """(out, grads) of the reference's layer under shard_map, per device
    as its trainer differentiates, and of the dense layer."""
    n, kind = case["n"], case["layer"]
    x, r = jnp.asarray(case["x"]), jnp.asarray(case["r"])
    xs, os_, _ = _specs(case)
    mesh = JaxMesh(np.array(jax.devices()[:n]), ("model",))
    if kind == "ce":
        pce = ParallelCrossEntropy()
        lbl = jnp.asarray(case["label"])

        def local(lg, r_):
            def loss(lg):
                out = pce(lg, lbl)
                return jnp.sum(out * r_), out
            (_, out), g = jax.value_and_grad(loss, has_aux=True)(lg)
            return out, g
        fm = jax.shard_map(local, mesh=mesh,
                           in_specs=(P(None, "model"), P()),
                           out_specs=(P(), P(None, "model")),
                           check_vma=False)
        out, g = fm(x, r)
        dense = rF.cross_entropy(x, lbl, reduction="none")
        dg = jax.grad(lambda lg: jnp.sum(
            rF.cross_entropy(lg, lbl, reduction="none") * r))(x)
        return (out, [g]), (dense, [dg])
    layer = _layer(kind, case)
    params, _ = state_of(layer)
    pspecs = {k: (p.pspec if p.pspec is not None else P())
              for k, p in layer.named_parameters()}
    names = list(params)
    float_x = kind != "embedding"

    def local(params, x, r_):
        def loss(params, x):
            out, _ = functional_call(layer, params, {}, x)
            return jnp.sum(out * r_), out
        argnums = (0, 1) if float_x else (0,)
        (_, out), g = jax.value_and_grad(loss, argnums=argnums,
                                         has_aux=True)(params, x)
        return out, g
    gspecs = (dict(pspecs), P(*xs) if xs else P()) if float_x \
        else (dict(pspecs),)
    fm = jax.shard_map(local, mesh=mesh,
                       in_specs=(dict(pspecs), P(*xs) if xs else P(),
                                 P(*os_) if os_ else P()),
                       out_specs=(P(*os_) if os_ else P(), gspecs),
                       check_vma=False)
    out, g = fm(dict(params), x, r)
    grads = ([g[1]] if float_x else []) + [g[0][k] for k in names]

    def dense_fn(params, x):
        w = params["weight"]
        if kind == "embedding":
            y = jnp.take(w, x, axis=0)
        else:
            y = x @ w + (params["bias"] if "bias" in params else 0.0)
        return jnp.sum(y * r), y
    argnums = (0, 1) if float_x else (0,)
    (_, dout), dg = jax.value_and_grad(dense_fn, argnums=argnums,
                                       has_aux=True)(dict(params), x)
    dgrads = ([dg[1]] if float_x else []) + [dg[0][k] for k in names]
    return (out, grads), (dout, dgrads)


@pytest.mark.parametrize("n,name", [(n, c) for n in CASES
                                    for c in CASES[n]])
def test_layer_matches_the_reference_and_the_dense_layer(
        n, name, tmp_path_factory):
    ranks = _world(n, tmp_path_factory)
    case = CASES[n][name]
    _, os_, gspecs = _specs(case)
    out = _join([r["mp"][name]["out"] for r in ranks], os_)
    grads = [_join([r["mp"][name]["grads"][i] for r in ranks], s)
             for i, s in enumerate(gspecs)]
    (ref_out, ref_grads), dense = _ref(case)
    # the reference's gather_output=True differentiates lax.all_gather,
    # whose transpose sums the replicated cotangent over the n ranks: its
    # gradients are n times the dense layer's (ROADMAP Queue 3); the
    # port's gather takes its chunk back, as Megatron's split does
    scale = n if case.get("gather") else 1
    for want_out, want_grads in ((ref_out, [np.asarray(g) / scale
                                            for g in ref_grads]), dense):
        np.testing.assert_allclose(out, np.asarray(want_out), rtol=0,
                                   atol=ATOL, err_msg=f"{name} out")
        assert len(grads) == len(want_grads)
        for i, (g, w) in enumerate(zip(grads, want_grads)):
            np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=ATOL,
                                       err_msg=f"{name} grad {i}")


@pytest.mark.parametrize("n", sorted(CASES))
def test_an_all_reduce_with_an_all_reduce_backward_scales_gradients_by_n(
        n, tmp_path_factory):
    """The trap of ``reduce_from_parallel_region``'s docstring: the same
    row layer on an all-reduce with an all-reduce backward gives ``n`` times
    the dense gradient of the input and of the weight; the port's layer
    gives the dense one (the test above)."""
    ranks = _world(n, tmp_path_factory)
    name = "row-parallel-in"
    case = CASES[n][name]
    _, dense = _ref(case)
    specs = _specs(case)[2]
    naive = [_join([r["mp"][name]["naive"][i] for r in ranks], s)
             for i, s in enumerate(specs[:2])]
    port = [_join([r["mp"][name]["grads"][i] for r in ranks], s)
            for i, s in enumerate(specs[:2])]
    for got, mine, want in zip(naive, port, dense[1][:2]):
        np.testing.assert_allclose(got, n * np.asarray(want), rtol=0,
                                   atol=n * ATOL)
        np.testing.assert_allclose(mine, np.asarray(want), rtol=0,
                                   atol=ATOL)
        assert not np.allclose(got, mine, rtol=0, atol=ATOL)
