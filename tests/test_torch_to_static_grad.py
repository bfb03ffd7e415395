"""``jit.to_static`` keeps the backward of the port's own autograd ops.

The chunked and fused head losses (``ops/chunked_ce.py``,
``ops/fused_ce.py``), the ring (``ops/ring_attention.py``) and the sharded
lookup (``ops/sharded_embedding.py``) are library ops with their backward
registered, so a staged graph holds each as one node and autograd over
the graph reaches their backward, as the reference's ``to_static``
differentiates through its kernels' ``custom_vjp``.

- GPT at depth 2 and narrow widths (vocab 256, hidden 64, 4 heads, S 32),
  ``to_static`` of ``model.fused_head_loss(ids, lbl, ce_kernel=...)`` on
  the chunked head and on the pallas head (the kernels' plain versions
  on the CPU): two AdamW steps through autograd over the staged graph
  against two steps of the reference's converted loss under
  ``jax.value_and_grad`` and its AdamW, losses and a parameter within
  rtol 1e-4 (``tests/test_torch_gpt_sweep.py``'s bar for the same loss);
  the staged gradients against the port's eager ones, rtol 1e-6 (the
  graph replays the same ops: equal in practice).
- A layer whose backward is still a plain ``autograd.Function`` (the
  experts' ``_Combine``) raises ``LostGradientError``.
- The ring over ``sep`` and the lookup over ``data`` on a gloo world of 2
  (``torch_to_static_worker.py``): the staged loss and gradients equal
  the eager call's bit for bit, the op one node of the graph.
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


def test_a_plain_function_still_raises():
    from paddle_tpu_torch.incubate import MoELayer
    from paddle_tpu_torch.jit import LostGradientError
    port.seed(0)
    m = MoELayer(16, 32, 4)
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 8, 16)
                         .astype(np.float32))
    with pytest.raises(LostGradientError, match="_Combine"):
        port.jit.to_static(m)(x)


@pytest.mark.multihost(timeout=300)
def test_ring_and_lookup_keep_their_backward_when_staged(tmp_path_factory):
    ranks = worker.world(2, tmp_path_factory)
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
