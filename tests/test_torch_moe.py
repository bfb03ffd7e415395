"""The port's mixture of experts (``incubate/moe.py``) against the JAX
package's.

- ``top2_gating``: the dispatch mask bit for bit, on random logits, on a
  planted tie (two experts with equal logits: both sides take the first
  as the first choice) and with a capacity small enough to drop choices
  (the second choices queue behind every first choice); the combine
  weights and the aux loss within 2e-7 absolute (the gates are float32
  softmax values below 1: XLA's CPU ``exp`` and PyTorch's differ in the
  last bit on about half of the inputs, measured, so the gates may differ
  by an ulp or two);
- ``MoELayer`` with every expert local against the reference's layer on
  the same weights and tokens: output, aux loss and gradients, at the
  reference test's bar (rtol and atol 1e-5);
- expert parallelism on gloo worlds of 2 and 4 at ``{"model": n}``
  (``torch_ep_worker.py``), each rank holding its E/n experts:
  - tokens replicated over the axis (the reference test's ``in_specs``,
    ``tests/test_distributed.py:311-331``): every rank's output equals the
    reference's local layer and its ``shard_map`` over n devices; every
    gradient equals the local layer's, the experts' put together from
    the ranks' slices (the reference's ``shard_map`` transpose makes the
    experts' n times that: ROADMAP Oracle caveats);
  - tokens split over the axis (``split_tokens=True``): rank r's output
    equals the reference's layer on rank r's tokens (and its
    ``shard_map`` with the tokens split); the experts' gradients, put
    together from the ranks' slices, equal the sum over the ranks' token
    chunks of the reference's gradients; the gate's and the input's are
    each rank's own;
- a model of an ``MoELayer`` and a linear head, trained through
  ``ParallelTrainer`` at ``{"model": n}`` (n 2 and 4; ``Momentum(0.1,
  0.9)``, with and without a global-norm clip that binds), against the
  reference's trainer on one device: losses within rtol 1e-5, every
  parameter within ``TRAIN_ATOL`` (the experts put together from the
  ranks' slices). The reference's trainer at ``{"model": n}`` is pinned
  as different: it runs the layer under its ``shard_map`` with the batch
  replicated, so its experts' gradients are n times the single layer's
  (with the port's ``all_to_all`` route fed the same replicated batch,
  its losses are the reference's at ``{"model": 2}`` within 1e-7,
  measured); the trainer refuses a layer built with ``split_tokens=True``
  on a live axis.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from paddle_tpu import nn as rnn
from paddle_tpu import optimizer as ropt
from paddle_tpu.distributed.engine import ParallelTrainer as RefTrainer
from paddle_tpu.distributed.mesh import build_mesh as ref_build_mesh
from paddle_tpu.incubate import MoELayer as RefMoE
from paddle_tpu.incubate import top2_gating as ref_top2
from paddle_tpu.jit.functionalization import functional_call, state_of

from paddle_tpu_torch.incubate import MoELayer, top2_gating

import torch_ep_worker as worker

TOL = dict(rtol=1e-5, atol=1e-5)
GATE_ATOL = 2e-7
TRAIN_ATOL = 1e-6
KINDS = ("moe", "moe_train")


def _gating_cases():
    rs = np.random.RandomState(0)
    tie = rs.randn(16, 8).astype(np.float32)
    tie[:, 5] = tie[:, 2] = tie.max(axis=1) + 1.0   # first choice ties
    second = rs.randn(16, 8).astype(np.float32)
    second[:, 6] = second[:, 1] = second.max(axis=1) + 0.5
    second[:, 0] = second.max(axis=1) + 1.0         # second choice ties
    return {"random": (rs.randn(64, 8).astype(np.float32), 16),
            "tie_first": (tie, 32),
            "tie_second": (second, 32),
            "overflow": (rs.randn(64, 4).astype(np.float32) * 3, 8)}


@pytest.mark.parametrize("name", list(_gating_cases()))
def test_top2_gating_matches_the_reference(name):
    logits, cap = _gating_cases()[name]
    c_ref, d_ref, a_ref = ref_top2(jnp.asarray(logits), cap)
    c, d, a = top2_gating(torch.from_numpy(logits), cap)
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_ref))
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), rtol=0,
                               atol=GATE_ATOL)
    np.testing.assert_allclose(float(a), float(a_ref), rtol=0,
                               atol=GATE_ATOL * logits.shape[1])
    if name.startswith("tie"):
        # the planted tie: the first of the equal experts is chosen, the
        # other only as a second choice (tie_first) or not at all
        routed = d.numpy().any(axis=2)
        if name == "tie_first":
            assert routed[:, 2].all() and routed[:, 5].all()
            assert routed.sum() == 2 * logits.shape[0]
        else:
            assert routed[:, 0].all() and routed[:, 1].all()
            assert not routed[:, 6].any()
    if name == "overflow":
        kept = d.numpy().sum()
        assert kept < 2 * logits.shape[0]     # choices were dropped


def _ref_layer(state):
    layer = RefMoE(**worker.MOE_CFG)
    layer.set_state_dict({k: jnp.asarray(v) for k, v in state.items()})
    return layer


def _ref_grads(layer, x, r):
    """(out, aux, param grads, x grad) of sum(layer(x) * r), eagerly."""
    params, buffers = state_of(layer)

    def loss(p, xx):
        out, nb = functional_call(layer, p, buffers, xx)
        return jnp.sum(out * r), (out, nb["aux_loss"])

    (_, (out, aux)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(dict(params), jnp.asarray(x))
    return (np.asarray(out), float(aux),
            {k: np.asarray(v) for k, v in gp.items()}, np.asarray(gx))


def test_moe_layer_local_matches_the_reference():
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    mesh_mod.set_mesh(None)
    state, x, r = worker.moe_data()
    out, aux, gp, gx = _ref_grads(_ref_layer(state), x, r)
    layer = MoELayer(**worker.MOE_CFG)
    layer.set_state_dict_from_numpy(state)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = layer(xt)
    names = [k for k, _ in layer.named_parameters()]
    grads = torch.autograd.grad((y * torch.from_numpy(r)).sum(),
                                [xt] + list(layer.parameters()))
    np.testing.assert_allclose(y.detach().numpy(), out, **TOL)
    np.testing.assert_allclose(float(layer.aux_loss), aux, **TOL)
    np.testing.assert_allclose(grads[0].numpy(), gx, **TOL)
    for k, g in zip(names, grads[1:]):
        np.testing.assert_allclose(g.numpy(), gp[k], **TOL, err_msg=k)
    assert "aux_loss" not in layer.state_dict()


def test_moe_capacity_follows_the_reference_rule():
    layer = MoELayer(16, 32, num_experts=8)
    for tokens in (16, 64, 1000, 8192):
        cap = int(2.0 * tokens * 2 / 8) or 1
        assert layer.capacity(tokens) == max(8, ((cap + 7) // 8) * 8)


def _ref_ep(state, x, n, split):
    """The reference's layer under shard_map over ``n`` devices on the
    model axis (its explicit expert-parallel branch)."""
    layer = _ref_layer(state)
    params, buffers = state_of(layer)
    mesh = JaxMesh(np.array(jax.devices()[:n]), ("model",))
    spec = P("model") if split else P()
    f = jax.shard_map(
        lambda p, xx: functional_call(layer, p, buffers, xx)[0], mesh=mesh,
        in_specs=(P(), spec), out_specs=spec, check_vma=False)
    return np.asarray(f(dict(params), jnp.asarray(x)))


@pytest.mark.multihost(timeout=300)
@pytest.mark.parametrize("n", [2, 4])
def test_expert_parallel_tokens_replicated(n, tmp_path_factory):
    state, x, r = worker.moe_data()
    ranks = worker.world(n, tmp_path_factory, kinds=KINDS)
    out, aux, gp, gx = _ref_grads(_ref_layer(state), x, r)
    ep = _ref_ep(state, x, n, split=False)
    np.testing.assert_allclose(ep, out, **TOL)
    e = worker.MOE_CFG["num_experts"] // n
    for rank, got in enumerate(ranks):
        g = got["moe"]["replicated"]
        assert g["shapes"]["w1"] == (e, 16, 32) and g["pspec"][0] == "model"
        np.testing.assert_allclose(g["out"], out, **TOL)
        np.testing.assert_allclose(g["aux"], aux, **TOL)
        np.testing.assert_allclose(g["grad_x"], gx, **TOL)
        np.testing.assert_allclose(g["grads"]["gate.weight"],
                                   gp["gate.weight"], **TOL)
        for k in ("w1", "b1", "w2", "b2"):
            np.testing.assert_allclose(
                g["grads"][k], gp[k][rank * e:(rank + 1) * e], **TOL,
                err_msg=k)


@pytest.mark.multihost(timeout=300)
@pytest.mark.parametrize("n", [2, 4])
def test_expert_parallel_tokens_split(n, tmp_path_factory):
    state, x, r = worker.moe_data()
    ranks = worker.world(n, tmp_path_factory, kinds=KINDS)
    layer = _ref_layer(state)
    c = x.shape[0] // n
    ep = _ref_ep(state, x, n, split=True)
    whole = {k: 0.0 for k in ("w1", "b1", "w2", "b2")}
    for rank in range(n):
        sl = slice(rank * c, (rank + 1) * c)
        out, aux, gp, gx = _ref_grads(layer, x[sl], r[sl])
        g = ranks[rank]["moe"]["split"]
        np.testing.assert_allclose(g["out"], out, **TOL)
        np.testing.assert_allclose(g["out"], ep[sl], **TOL)
        np.testing.assert_allclose(g["aux"], aux, **TOL)
        np.testing.assert_allclose(g["grad_x"], gx, **TOL)
        np.testing.assert_allclose(g["grads"]["gate.weight"],
                                   gp["gate.weight"], **TOL)
        for k in whole:
            whole[k] = whole[k] + gp[k]
    for k, want in whole.items():
        got = np.concatenate([ranks[rank]["moe"]["split"]["grads"][k]
                              for rank in range(n)])
        np.testing.assert_allclose(got, want, **TOL, err_msg=k)


def test_experts_split_over_a_non_own_axis_raise():
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    mesh_mod.set_mesh(mesh_mod.Mesh({"data": 2}, rank=0))
    try:
        with pytest.raises(ValueError, match="model"):
            MoELayer(16, 32, num_experts=8, axis_name="data")
    finally:
        mesh_mod.set_mesh(None)


class _RefMoENet(rnn.Layer):
    def __init__(self):
        super().__init__()
        self.moe = RefMoE(**worker.MOE_CFG)
        self.head = rnn.Linear(16, 4)

    def forward(self, x):
        return self.head(self.moe(x).mean(axis=1)), self.moe.aux_loss


_REF_TRAIN = {}


def _ref_train(n, name):
    """(losses, params) of the reference's trainer at ``{"model": n}``."""
    if (n, name) not in _REF_TRAIN:
        case = worker.MOE_TRAIN_CASES[name]
        state, x, y = worker.moe_train_data()
        m = _RefMoENet()
        m.set_state_dict({k: jnp.asarray(v) for k, v in state.items()})
        clip = (ropt.ClipGradByGlobalNorm(case["clip"]) if case["clip"]
                else None)
        tr = RefTrainer(m, ropt.Momentum(case["lr"], momentum=0.9,
                                         grad_clip=clip,
                                         parameters=m.parameters()),
                        worker.moe_train_loss(rnn.functional),
                        mesh=ref_build_mesh({"model": n}))
        losses = [float(tr.train_step(jnp.asarray(x), jnp.asarray(y)))
                  for _ in range(worker.MOE_TRAIN_STEPS)]
        _REF_TRAIN[(n, name)] = (losses, {k: np.asarray(v) for k, v in
                                          tr.state["params"].items()})
    return _REF_TRAIN[(n, name)]


@pytest.mark.multihost(timeout=300)
@pytest.mark.parametrize("n,name", [(n, c) for n in (2, 4)
                                    for c in worker.MOE_TRAIN_CASES])
def test_moe_model_trains_as_the_reference_trainer_on_one_device(
        n, name, tmp_path_factory):
    ranks = worker.world(n, tmp_path_factory, kinds=KINDS)
    losses, params = _ref_train(1, name)
    # the reference's own trainer at model n: n-fold expert gradients
    ref_n, _ = _ref_train(n, name)
    assert abs(ref_n[1] - losses[1]) > 1e-3 * abs(losses[1])
    state, _, _ = worker.moe_train_data()
    for got in ranks:
        g = got["moe_train"][name]
        assert g["skipped"] == 0
        np.testing.assert_allclose(g["losses"], losses, rtol=1e-5)
    assert ranks[0]["moe_train"][name]["losses"][-1] < losses[0]
    assert set(ranks[0]["moe_train"][name]["params"]) == set(params)
    for k, want in params.items():
        parts = [r["moe_train"][name]["params"][k] for r in ranks]
        got = (np.concatenate(parts) if k.split(".")[-1] in
               ("w1", "b1", "w2", "b2") else parts[0])
        for other in parts[1:] if got is parts[0] else ():
            np.testing.assert_array_equal(other, got, err_msg=k)
        assert not np.array_equal(want, state[k]), k    # it moved
        np.testing.assert_allclose(got, want, rtol=0, atol=TRAIN_ATOL,
                                   err_msg=k)


@pytest.mark.multihost(timeout=300)
@pytest.mark.parametrize("n", [2, 4])
def test_trainer_refuses_split_tokens_on_a_live_axis(n, tmp_path_factory):
    ranks = worker.world(n, tmp_path_factory, kinds=KINDS)
    for got in ranks:
        msg = got["moe_train"]["split_tokens_raise"]
        assert msg is not None and "split_tokens" in msg
