"""``jit.to_static`` keeps the backward of the port's own autograd ops.

The chunked and fused head losses (``ops/chunked_ce.py``,
``ops/fused_ce.py``), the ring (``ops/ring_attention.py``), the sharded
lookup (``ops/sharded_embedding.py``), the experts' exchanges, dispatch and
combine (``incubate/moe.py``) and Megatron's operators (``mp_layers.py``)
are library ops with their backward registered, so a staged graph holds
each as one node and autograd over the graph reaches their backward, as
the reference's ``to_static`` differentiates through its kernels'
``custom_vjp``.

- GPT at depth 2 and narrow widths (vocab 256, hidden 64, 4 heads, S 32),
  ``to_static`` of ``model.fused_head_loss(ids, lbl, ce_kernel=...)`` on
  the chunked head and on the pallas head (the kernels' plain versions
  on the CPU): two AdamW steps through autograd over the staged graph
  against two steps of the reference's converted loss under
  ``jax.value_and_grad`` and its AdamW, losses and a parameter within
  rtol 1e-4 (``tests/test_torch_gpt_sweep.py``'s bar for the same loss);
  the staged gradients against the port's eager ones, rtol 1e-6 (the
  graph replays the same ops: equal in practice).
- A staged ``MoELayer(16, 32, 4)`` and a staged Megatron stack
  (``torch_to_static_worker.megatron_stack``) without a mesh (model
  degree 1): two SGD steps through the staged graph equal two eager steps
  from the same seed (losses and parameters rtol 1e-6: the graph replays
  the same ops), and the MoE layer's losses and parameters are within
  rtol 1e-5 of the reference's staged layer (``jit.to_static`` under
  ``jax.value_and_grad``) on the same weights and SGD.
- A function whose backward is a user-defined ``autograd.Function``
  raises ``LostGradientError`` naming it: the trace inlines its forward.
- The ring over ``sep``, the lookup over ``data``, and the MoE layer and
  the Megatron stack at ``{"model": 2}`` on a gloo world of 2
  (``torch_to_static_worker.py``): the staged losses and gradients (the
  trained parameters for the last two) equal the eager ones bit for
  bit, each op a node of the graph.
"""
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as ref
import paddle_tpu_torch as port

import torch_to_static_worker as worker

CFG = dict(tensor_parallel=False, vocab_size=256, hidden_size=64,
           num_layers=2, num_heads=4, max_position_embeddings=64,
           attn_dropout=0.0, hidden_dropout=0.0)
LR = 3e-4


def _batch(seed=3, b=2, s=32):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, 256, (b, s)).astype(np.int32)
    lbl = rs.randint(0, 256, (b, s)).astype(np.int32)
    lbl[0, :5] = -100
    return ids, lbl


def _pair():
    from paddle_tpu.text.models import GPTForPretraining as RefGPT
    from paddle_tpu_torch.text.models import GPTForPretraining
    ref.seed(0)
    rm = RefGPT(**CFG)
    pm = GPTForPretraining(**CFG)
    pm.set_state_dict_from_numpy({k: np.asarray(v)
                                  for k, v in rm.state_dict().items()})
    return rm, pm


def _head_loss(pm, head):
    def loss(ids, lbl):
        return pm.fused_head_loss(ids, lbl, ce_kernel=head)
    return loss


def _ref_steps(rm, head, ids, lbl, steps=2):
    from paddle_tpu.jit.functionalization import functional_call, state_of

    class Loss(ref.nn.Layer):
        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def forward(self, i, t):
            return self.inner.fused_head_loss(i, t, ce_kernel=head)

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        conv = ref.jit.to_static(Loss(rm)).layer
    params, buffers = state_of(conv)
    params = dict(params)
    vg = jax.jit(jax.value_and_grad(
        lambda p, i, t: functional_call(conv, p, buffers, i, t)[0]))
    opt = ref.optimizer.AdamW(LR)
    state = opt.init_state(params)
    losses = []
    for _ in range(steps):
        loss, grads = vg(params, jnp.asarray(ids), jnp.asarray(lbl))
        params, state = opt.apply_gradients(params, grads, state)
        losses.append(float(loss))
    return losses, {k[len("inner."):]: np.asarray(v)
                    for k, v in params.items()}


@pytest.mark.parametrize("head", ["chunked", "pallas"])
def test_staged_gpt_loss_trains_as_the_reference(head):
    from paddle_tpu_torch.optimizer import AdamW
    rm, pm = _pair()
    ids, lbl = _batch()
    want, want_params = _ref_steps(rm, head, ids, lbl)
    staged = port.jit.to_static(_head_loss(pm, head))
    opt = AdamW(LR, parameters=pm.parameters())
    ti, tt = torch.from_numpy(ids), torch.from_numpy(lbl)
    got = []
    for _ in range(2):
        opt.clear_grad()
        loss = staged(ti, tt)
        loss.backward()
        opt.step()
        got.append(loss.item())
    np.testing.assert_allclose(got, want, rtol=1e-4)
    name = "gpt.embeddings.word_embeddings.weight"
    np.testing.assert_allclose(dict(pm.named_parameters())[name].detach()
                               .numpy(), want_params[name], rtol=1e-4,
                               atol=1e-6)
    ops = [str(n.target) for n in staged.graph(ti, tt).graph.nodes]
    node = {"chunked": "chunked_ce_grad", "pallas": "fused_ce_fwd"}[head]
    assert sum(node in o for o in ops) == 1


@pytest.mark.parametrize("head", ["chunked", "pallas"])
def test_staged_gradients_equal_the_eager_ones(head):
    _, pm = _pair()
    ti, tt = (torch.from_numpy(a) for a in _batch())
    params = list(pm.parameters())
    staged = port.jit.to_static(_head_loss(pm, head))
    g_staged = torch.autograd.grad(staged(ti, tt), params)
    g_eager = torch.autograd.grad(pm.fused_head_loss(ti, tt,
                                                     ce_kernel=head), params)
    for a, b in zip(g_staged, g_eager):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-12)


class _UserDouble(torch.autograd.Function):
    """A user's Function: the trace inlines its forward."""

    @staticmethod
    def forward(ctx, x):
        return x * 2

    @staticmethod
    def backward(ctx, g):
        return g * 2


def _user_loss(x):
    return _UserDouble.apply(x).sum()


def test_a_plain_function_still_raises():
    from paddle_tpu_torch.jit import LostGradientError
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(LostGradientError, match="_UserDouble"):
        port.jit.to_static(_user_loss)(x)


def _ref_moe_steps(x, coef, steps=worker.TRAIN_STEPS, lr=worker.TRAIN_LR):
    """The reference's staged ``MoELayer``: ``steps`` SGD steps of
    ``sum(layer(x) * coef)`` under ``jax.value_and_grad``."""
    from paddle_tpu.jit.functionalization import functional_call, state_of
    rm = worker.moe_layer(ref)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        conv = ref.jit.to_static(rm).layer
    params, buffers = state_of(conv)
    params = dict(params)
    vg = jax.jit(jax.value_and_grad(lambda p, xx: jnp.sum(
        functional_call(conv, p, buffers, xx)[0] * coef)))
    losses = []
    for _ in range(steps):
        loss, grads = vg(params, jnp.asarray(x))
        params = {k: v - lr * grads[k] for k, v in params.items()}
        losses.append(float(loss))
    return rm, losses, {k: np.asarray(v) for k, v in params.items()}


def test_staged_moe_trains_as_eager_and_the_reference():
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    mesh_mod.set_mesh(None)
    x, coef = worker.moe_data()
    rm, want, want_params = _ref_moe_steps(x, coef)
    state = {k: np.asarray(v) for k, v in rm.state_dict().items()}

    def build(pd):
        m = worker.moe_layer(pd)
        m.set_state_dict_from_numpy(state)
        return m
    (el, ep), (sl, sp), ops = worker.train_both(
        build, torch.from_numpy(x), torch.from_numpy(coef))
    np.testing.assert_allclose(sl, el, rtol=1e-6)
    for a, b in zip(sp, ep):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(sl, want, rtol=1e-5)
    names = [n for n, _ in build(port).named_parameters()]
    for n, got in zip(names, sp):
        np.testing.assert_allclose(got, want_params[n], rtol=1e-5,
                                   atol=1e-6)
    for op in ("moe_dispatch", "moe_combine"):
        assert sum(op in o for o in ops) == 1, (op, ops)


def test_staged_megatron_stack_trains_as_eager():
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    mesh_mod.set_mesh(None)
    ids, coef = worker.megatron_data()
    (el, ep), (sl, sp), _ = worker.train_both(
        worker.megatron_stack, torch.from_numpy(ids),
        torch.from_numpy(coef))
    np.testing.assert_allclose(sl, el, rtol=1e-6)
    assert el[1] < el[0]
    for a, b in zip(sp, ep):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-12)


_WORLD = {}


def _world(tmp_path_factory):
    if "ranks" not in _WORLD:
        _WORLD["ranks"] = worker.world(2, tmp_path_factory)
    return _WORLD["ranks"]


@pytest.mark.multihost(timeout=300)
def test_staged_moe_and_megatron_train_as_eager_at_mp2(tmp_path_factory):
    for r in _world(tmp_path_factory):
        for name, want_ops in (("moe", ("moe_own_chunk", "moe_gather_chunks",
                                        "moe_dispatch", "moe_combine")),
                               ("megatron", ("mp_reduce_from_model",
                                             "mp_copy_to_model"))):
            (el, ep), (sl, sp), ops = r[name]
            assert sl == el, name
            for a, b in zip(sp, ep):
                np.testing.assert_array_equal(a, b)
            for op in want_ops:
                assert any(op in o for o in ops), (name, op, ops)
            assert all(np.isfinite(l) for l in el), name


@pytest.mark.multihost(timeout=300)
def test_ring_and_lookup_keep_their_backward_when_staged(tmp_path_factory):
    ranks = _world(tmp_path_factory)
    for r in ranks:
        for name, op in (("ring", "ring_attention"),
                         ("lookup", "alltoall_lookup")):
            (el, eg), (sl, sg), ops = r[name]
            assert sl == el, name
            for a, b in zip(sg, eg):
                np.testing.assert_array_equal(a, b)
            assert sum(op in o for o in ops) == 1, (name, ops)
            assert all(np.isfinite(g).all() and np.abs(g).sum() > 0
                       for g in eg), name
