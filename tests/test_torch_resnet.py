"""The port's ResNet family (``vision/models/resnet.py``) and its training
through ``ParallelTrainer`` against the JAX package's, on the CPU.

- ``resnet18`` at bench_resnet50's CPU shapes (32x32 images, batch 4), in
  float32, from the golden recipe's weights (``torch_resnet_golden.py``),
  3 ``Momentum(R18_LR, 0.9)`` steps through each package's trainer: the
  losses within rtol 1e-4 at step 0 and 1e-3 after (the GPT golden's
  bars). ``R18_LR`` is 1e-2, not bench.py's 0.1: at 0.1 four images fit in
  one step and float32 itself drifts 2.9e-3 from float64 by the third
  step (measured, the port against itself), so no float32 pair could
  hold 1e-3 there; at 1e-2 the drift is 5.5e-5;
- one ``BottleneckBlock`` with a downsample, forward and backward in
  training mode: the output and the gradients of ``sum(out * r)`` at the
  conv tests' bars (rtol 1e-5, atol 1e-6 of the largest element);
- the running statistics (ROADMAP "Oracle caveats"): the reference's
  trainer leaves its buffers at their initial zeros and ones (its step
  discards the forward's new buffers); the port's trainer keeps the
  layers' updates, and after the three steps its buffers equal the
  reference's layers run eagerly (``functional_call``) on the same
  batches with the reference trainer's parameters of each step
  (rtol 1e-4: the statistics are means over the batch of activations
  that carry the parameters' small drift);
- a step the NaN guard skips keeps the buffers of the step before it, bit
  for bit, with the parameters; a recomputed forward (``remat=True``,
  ``recompute``) moves the buffers once: equal to the plain step's (both
  on a conv, batch norm, pool and linear model: the rules do not depend
  on the depth);
- each golden file's recipe rebuilds the port's state with the names and
  shapes of ``named_state``, and the ResNet-50 golden's step-0 loss holds
  on the CPU within 1e-4 and its gradient norm within
  ``GRAD_NORM_RTOL`` = 2e-3: the early layers' gradients cancel over
  the batch norms downstream, so float32 itself is 3.5e-4 (the JAX
  package) and 9.4e-4 (the port) off the float64 norm (41.0675; measured
  on the CPU, the port in float64), 6.0e-4 apart.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as rnn
from paddle_tpu.distributed.engine import ParallelTrainer as RefTrainer
from paddle_tpu.distributed.mesh import build_mesh as ref_build_mesh
from paddle_tpu.jit.functionalization import functional_call, state_of
from paddle_tpu.vision.models.resnet import BottleneckBlock as RefBottleneck
from paddle_tpu.vision.models import resnet18 as ref_resnet18

from paddle_tpu_torch import nn, optimizer as optim
from paddle_tpu_torch.distributed import mesh as mesh_mod
from paddle_tpu_torch.distributed.engine import ParallelTrainer
from paddle_tpu_torch.vision.models import (BottleneckBlock, resnet18,
                                            resnet50)

import torch_moe_golden as moe_golden
import torch_resnet_golden as golden

R18_LR, R18_BATCH, R18_SIZE, STEPS = 1e-2, 4, 32, 3
GRAD_NORM_RTOL = 2e-3
_REF, _PORT = {}, {}


def _ce_ref(o, y):
    return rnn.functional.cross_entropy(o, y)


def _ce(o, y):
    return nn.functional.cross_entropy(o, y)


def _r18_weights():
    model = resnet18()
    return golden.weights([(n, tuple(t.shape))
                           for n, t in model.named_state().items()])


def _batch():
    return golden.data(batch=R18_BATCH, size=R18_SIZE)


def _ref_run():
    """The reference trainer's losses, parameters before each step,
    buffers after the steps, and the buffers of its layers run eagerly
    on each step's batch."""
    if "r18" in _REF:
        return _REF["r18"]
    w = _r18_weights()
    model = ref_resnet18()
    model.set_state_dict({k: jnp.asarray(v) for k, v in w.items()})
    x, y = _batch()
    opt = paddle.optimizer.Momentum(R18_LR, momentum=0.9,
                                    parameters=model.parameters())
    tr = RefTrainer(model, opt, _ce_ref, mesh=ref_build_mesh({"data": 1}))
    losses, before = [], []
    for _ in range(STEPS):
        before.append({k: np.array(v, copy=True)
                       for k, v in tr.state["params"].items()})
        losses.append(float(tr.train_step(x, y)))
    buffers_after = {k: np.array(v, copy=True)
                     for k, v in tr.state["buffers"].items()}
    # the eager layers: each step's parameters, the buffers chained
    _, bufs = state_of(model)
    fwd = jax.jit(lambda p, b: functional_call(model, p, b,
                                               jnp.asarray(x))[1])
    for params in before:
        bufs = fwd({k: jnp.asarray(v) for k, v in params.items()},
                   dict(bufs))
    eager = {k: np.asarray(v) for k, v in bufs.items()}
    _REF["r18"] = (losses, buffers_after, eager)
    return _REF["r18"]


def _port_trainer(**kw):
    torch.manual_seed(0)
    model = resnet18()
    model.set_state_dict_from_numpy(_r18_weights())
    return ParallelTrainer(model, optim.Momentum(R18_LR, momentum=0.9), _ce,
                           mesh=mesh_mod.build_mesh({"data": 1}),
                           device="cpu", **kw)


def _buffers(trainer):
    return {k: v.detach().clone() for k, v in trainer.state["buffers"].items()}


def _port_run():
    """The port trainer's losses, skipped steps and buffers after the
    steps (one run for the tests below)."""
    if "r18" not in _PORT:
        tr = _port_trainer()
        x, y = _batch()
        losses = [float(tr.train_step(x, y.astype(np.int64)))
                  for _ in range(STEPS)]
        _PORT["r18"] = (losses, tr.skipped_steps(), _buffers(tr))
    return _PORT["r18"]


class _Small(nn.Layer):
    """conv -> batch norm -> ReLU -> pool -> linear: the buffer rules on a
    model that takes milliseconds a step."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2D(3, 8, 3, padding=1, bias_attr=False)
        self.bn = nn.BatchNorm2D(8)
        self.pool = nn.AdaptiveAvgPool2D(1)
        self.fc = nn.Linear(8, 1000)

    def forward(self, x):
        h = nn.functional.relu(self.bn(self.conv(x)))
        return self.fc(torch.flatten(self.pool(h), 1))


def _small_trainer(**kw):
    torch.manual_seed(0)
    from paddle_tpu_torch import framework
    framework.seed(0)
    return ParallelTrainer(_Small(), optim.Momentum(R18_LR, momentum=0.9),
                           _ce, mesh=mesh_mod.build_mesh({"data": 1}),
                           device="cpu", **kw)


def test_resnet18_trains_as_the_reference():
    losses, _, _ = _ref_run()
    got, skipped, _ = _port_run()
    assert skipped == 0
    np.testing.assert_allclose(got[0], losses[0], rtol=1e-4)
    np.testing.assert_allclose(got[1:], losses[1:], rtol=1e-3)
    assert got[-1] < got[0]


def test_trainer_keeps_the_eager_layers_buffer_updates():
    _, ref_trainer_buffers, eager = _ref_run()
    # the reference trainer drops the updates: zeros and ones after 3 steps
    for k, v in ref_trainer_buffers.items():
        want = 0.0 if k.endswith("_mean") else 1.0
        np.testing.assert_array_equal(v, np.full_like(v, want), err_msg=k)
    _, _, got = _port_run()
    assert set(got) == set(eager)
    for k, v in eager.items():
        np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-4,
                                   atol=1e-5 * max(1.0, np.abs(v).max()),
                                   err_msg=k)
        assert not np.allclose(v, 0.0 if k.endswith("_mean") else 1.0)


def test_a_skipped_step_keeps_the_buffers():
    tr = _small_trainer()
    x, y = _batch()
    y = y.astype(np.int64)
    tr.train_step(x, y)
    bufs = _buffers(tr)
    params = {k: v.detach().clone() for k, v in tr.params.items()}
    tr.train_step(x, y, grad_taint=float("nan"))
    assert tr.skipped_steps() == 1
    for k, v in _buffers(tr).items():
        torch.testing.assert_close(v, bufs[k], rtol=0, atol=0)
    for k, v in tr.params.items():
        torch.testing.assert_close(v.detach(), params[k], rtol=0, atol=0)
    tr.train_step(x, y)       # the next step moves them again
    assert not torch.equal(_buffers(tr)["bn._mean"], bufs["bn._mean"])


def test_recompute_moves_the_stats_once():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # the two runs' CPU sums in one order
    try:
        x, y = _batch()
        y = y.astype(np.int64)
        plain, remat = _small_trainer(), _small_trainer(remat=True)
        plain.train_step(x, y)
        remat.train_step(x, y)
        want, got = _buffers(plain), _buffers(remat)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=1e-6,
                                       atol=1e-7, msg=k)
        # fleet.utils.recompute on one block: one update
        from paddle_tpu_torch.distributed.fleet.utils import recompute
        torch.manual_seed(1)
        block = nn.Sequential(nn.Conv2D(4, 4, 3, padding=1),
                              nn.BatchNorm2D(4), nn.ReLU())
        xb = torch.randn(2, 4, 6, 6, requires_grad=True)
        out = recompute(block, xb)
        once = block[1]._mean.clone()
        out.sum().backward()
        torch.testing.assert_close(block[1]._mean, once, rtol=0, atol=0)
        assert not torch.equal(once, torch.zeros(4))
    finally:
        torch.set_num_threads(threads)


def test_bottleneck_block_forward_and_backward():
    paddle.seed(2)
    down = rnn.Sequential(rnn.Conv2D(32, 64, 1, stride=2, bias_attr=False),
                          rnn.BatchNorm2D(64))
    ref = RefBottleneck(32, 16, stride=2, downsample=down)
    torch.manual_seed(2)
    port = BottleneckBlock(32, 16, stride=2, downsample=nn.Sequential(
        nn.Conv2D(32, 64, 1, stride=2, bias_attr=False), nn.BatchNorm2D(64)))
    state = {k: np.asarray(v) for k, v in ref.state_dict().items()}
    port.set_state_dict_from_numpy(state)
    assert list(port.named_state()) == list(state)
    rs = np.random.RandomState(3)
    x = rs.randn(4, 32, 8, 8).astype(np.float32)
    r = rs.randn(4, 64, 4, 4).astype(np.float32)
    params, buffers = state_of(ref)

    def loss(p, xx):
        out, nb = functional_call(ref, p, buffers, xx)
        return jnp.sum(out * r), (out, nb)

    (_, (out, nb)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(dict(params), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = port(xt)
    names = [k for k, _ in port.named_parameters()]
    grads = torch.autograd.grad((y * torch.from_numpy(r)).sum(),
                                [xt] + list(port.parameters()))

    def close(got, want, msg):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-6 * max(1.0, np.abs(want).max()),
                                   err_msg=msg)

    close(y.detach().numpy(), out, "out")
    close(grads[0].numpy(), gx, "x grad")
    for k, g in zip(names, grads[1:]):
        close(g.numpy(), gp[k], k)
    for k, v in nb.items():
        close(port.state_dict()[k].numpy(), v, k)


@pytest.mark.parametrize("which", ["resnet", "moe"])
def test_golden_recipes_rebuild_the_port_state(which):
    from paddle_tpu_torch.incubate import MoELayer
    mesh_mod.set_mesh(None)
    mod = golden if which == "resnet" else moe_golden
    gold = mod.load()
    model = resnet50() if which == "resnet" else MoELayer(**{
        k: v for k, v in gold["config"].items()})
    names_shapes = [(n, tuple(t.shape)) for n, t in
                    model.named_state().items()]
    assert [[n, list(s)] for n, s in names_shapes] == gold["names_shapes"]
    w = mod.weights(names_shapes, gold["recipe"]["weights"]["seed"])
    assert [(k, v.shape) for k, v in w.items()] == names_shapes
    model.set_state_dict_from_numpy(w)


def test_resnet50_golden_step0_on_the_cpu():
    gold = golden.load()
    cfg = gold["config"]
    assert cfg["model"] == "resnet50" and cfg["dtype"] == "float32"
    model = resnet50()
    names_shapes = [(n, tuple(t.shape)) for n, t in
                    model.named_state().items()]
    model.set_state_dict_from_numpy(golden.weights(
        names_shapes, gold["recipe"]["weights"]["seed"]))
    x, y = golden.data(gold["recipe"]["data"]["seed"], cfg["batch"],
                       cfg["image"])
    loss = _ce(model(torch.from_numpy(x)), torch.from_numpy(y).long())
    grads = torch.autograd.grad(loss, list(model.parameters()))
    gnorm = torch.sqrt(sum(g.double().square().sum() for g in grads)).item()
    np.testing.assert_allclose(float(loss), gold["losses"][0], rtol=1e-4)
    np.testing.assert_allclose(gnorm, gold["step0_grad_norm"],
                               rtol=GRAD_NORM_RTOL)
