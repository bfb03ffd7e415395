"""The single-card GPT sweep of the PyTorch port against the JAX package, on
the CPU: the fused-CE head loss, the dense head (``forward`` +
``cross_entropy``), remat, gradient merge, LR schedulers and regularizers.

The reference model's ``state_dict()`` is loaded into the port at
``gpt_tiny`` widths (vocab 1024, hidden 128, 2 layers, 4 heads; seq 128,
batch 2). On the CPU attention takes the plain path on both sides and the
port's fused CE its kernels' plain versions; the reference's fused CE runs
in Pallas interpret mode. Tolerances are ``test_torch_gpt_train.py``'s:
loss and gradients of one call atol 1e-5, rtol 1e-4; ``train_step``
losses rtol 1e-4 (dropout 0 wherever the two sides are compared: the two
frameworks draw different masks). Remat with dropout 0.1 is held against
the port's own non-remat step: same seed, same masks, equal gradients.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as rnn
from paddle_tpu.distributed.engine import ParallelTrainer as RefTrainer
from paddle_tpu.jit.functionalization import functional_call, state_of
from paddle_tpu.optimizer import lr as ref_lr
from paddle_tpu.text.models import GPTForPretraining as RefGPT
from paddle_tpu.text.models import gpt_tiny
from tools._mesh_setup import data_mesh

from paddle_tpu_torch import framework, regularizer
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.distributed.engine import ParallelTrainer
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import fused_ce
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.optimizer import lr as port_lr
from paddle_tpu_torch.text.models import GPTForPretraining
from torch_threads import two_threads  # noqa: F401

BATCH, SEQ = 2, 128
CFG = dict(tensor_parallel=False, attn_dropout=0.0, hidden_dropout=0.0,
           **gpt_tiny())


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _loss_layer(base, model, ce_kernel):
    class FusedLoss(base):
        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def forward(self, batch):
            ids, lbl = batch
            return self.inner.fused_head_loss(ids, lbl, ce_kernel=ce_kernel)

    return FusedLoss(model)


def _pair(**over):
    cfg = dict(CFG, **over)
    paddle.seed(0)
    ref = RefGPT(**cfg)
    port = GPTForPretraining(**cfg)
    port.set_state_dict_from_numpy(
        {k: np.asarray(v) for k, v in ref.state_dict().items()})
    return ref, port


def _batch(seed=3):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, 1024, (BATCH, SEQ)).astype(np.int32)
    lbl = rs.randint(0, 1024, (BATCH, SEQ)).astype(np.int32)
    lbl[0, :9] = -100          # a few ignored positions
    return ids, lbl


def _fused_trainers(ref, port, ce_kernel="pallas", ref_opt=None,
                    port_opt=None, **kw):
    data_mesh(1)
    ref_tr = RefTrainer(_loss_layer(rnn.Layer, ref, ce_kernel),
                        ref_opt or paddle.optimizer.AdamW(
                            3e-4, parameters=ref.parameters()),
                        lambda out, _l: out, **kw)
    port_tr = ParallelTrainer(_loss_layer(tnn.Layer, port, ce_kernel),
                              port_opt or AdamW(3e-4), lambda out, _l: out,
                              device="cpu", **kw)
    return ref_tr, port_tr


def _three_steps(ref_tr, port_tr, inputs, labels, after=None):
    for step in range(3):
        want = float(ref_tr.train_step(inputs, labels))
        got = float(port_tr.train_step(inputs, labels))
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   err_msg=f"step {step}")
        if after is not None:
            after()
    assert port_tr.skipped_steps() == 0 and ref_tr.skipped_steps() == 0


def test_fused_head_loss_pallas_matches_the_reference():
    ref, port = _pair()
    ids, lbl = _batch()
    wrapped = _loss_layer(rnn.Layer, ref, "pallas")
    params, buffers = state_of(wrapped)
    loss, grads = jax.value_and_grad(
        lambda p: functional_call(wrapped, p, buffers, (ids, lbl))[0])(params)
    pw = _loss_layer(tnn.Layer, port, "pallas")
    n0 = dict(fused_ce.LAUNCHES)
    ploss = pw((torch.from_numpy(ids), torch.from_numpy(lbl)))
    ploss.backward()
    assert fused_ce.LAUNCHES == n0            # plain versions on the CPU
    np.testing.assert_allclose(ploss.item(), float(loss), rtol=1e-4,
                               atol=1e-5)
    pgrads = dict(pw.named_parameters())
    assert set(pgrads) == set(grads)
    for name, g in grads.items():
        np.testing.assert_allclose(pgrads[name].grad.numpy(), np.asarray(g),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_three_steps_on_the_fused_ce_kernels_match_the_reference():
    ref, port = _pair()
    ids, lbl = _batch()
    _three_steps(*_fused_trainers(ref, port), (ids, lbl), 0.0)


def test_three_steps_on_the_dense_head_match_the_reference():
    ref, port = _pair()
    ids, lbl = _batch()
    data_mesh(1)
    ref_tr = RefTrainer(
        ref, paddle.optimizer.AdamW(3e-4, parameters=ref.parameters()),
        lambda logits, y: rnn.functional.cross_entropy(logits, y))
    port_tr = ParallelTrainer(port, AdamW(3e-4),
                              lambda logits, y: F.cross_entropy(logits, y),
                              device="cpu")
    _three_steps(ref_tr, port_tr, ids, lbl)


def test_three_remat_steps_match_the_reference():
    ref, port = _pair()
    ids, lbl = _batch()
    _three_steps(*_fused_trainers(ref, port, remat=True), (ids, lbl), 0.0)


def test_three_gradient_merge_steps_match_the_reference():
    ref, port = _pair()
    ids, lbl = _batch()
    ref_tr, port_tr = _fused_trainers(ref, port, accumulate_steps=2)
    # labels as an array: the reference splits every leaf of (inputs, labels)
    _three_steps(ref_tr, port_tr, (ids, lbl), lbl)
    with pytest.raises(ValueError, match="not divisible"):
        port_tr.train_step((ids[:1], lbl[:1]), lbl[:1])


def test_gradient_merge_is_the_mean_of_its_chunks():
    """K = 2 on one batch gives the loss and update of two half batches'
    mean gradient (no dropout)."""
    _, port = _pair()
    _, port2 = _pair()
    ids, lbl = _batch()
    merged = ParallelTrainer(_loss_layer(tnn.Layer, port, "pallas"),
                             AdamW(3e-4), lambda out, _l: out, device="cpu",
                             accumulate_steps=2)
    loss = merged.train_step((ids, lbl), 0.0)
    wrapped = _loss_layer(tnn.Layer, port2, "pallas")
    losses, grads = [], []
    for i in range(2):
        li = wrapped((torch.from_numpy(ids[i:i + 1]),
                      torch.from_numpy(lbl[i:i + 1])))
        losses.append(li)
        grads.append(torch.autograd.grad(li, list(wrapped.parameters())))
    torch.testing.assert_close(loss, (losses[0] / 2 + losses[1] / 2).detach())
    opt = AdamW(3e-4)
    params = {n: p.detach() for n, p in wrapped.named_parameters()}
    mean = {n: (a + b) / 2 for n, a, b in zip(params, *grads)}
    new, _ = opt.apply_gradients(params, mean, opt.init_state(params))
    for n in params:
        torch.testing.assert_close(merged.get_param(n), new[n], rtol=1e-5,
                                   atol=1e-7)


def _dropout_grads(remat, ids, lbl, replay=True):
    _, port = _pair(attn_dropout=0.1, hidden_dropout=0.1)
    tr = ParallelTrainer(_loss_layer(tnn.Layer, port, "pallas"), AdamW(3e-4),
                         lambda out, _l: out, device="cpu", remat=remat)
    framework.seed(5)
    names = list(tr.params)
    inputs = (torch.from_numpy(ids), torch.from_numpy(lbl))
    if replay:
        loss, grads = tr._grads(names, inputs, None)
    else:   # a bare checkpoint: the recompute draws new masks
        out = torch.utils.checkpoint.checkpoint(tr.model, inputs,
                                                use_reentrant=False)
        loss = out
        grads = torch.autograd.grad(loss, [tr.params[n] for n in names])
    after = framework.get_generator("cpu").get_state()
    return loss.detach(), dict(zip(names, grads)), after


def test_remat_with_dropout_gives_the_non_remat_gradients():
    ids, lbl = _batch()
    l0, g0, s0 = _dropout_grads(False, ids, lbl)
    l1, g1, s1 = _dropout_grads(True, ids, lbl)
    assert torch.equal(l0, l1)
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=1e-5, atol=1e-7,
                                   msg=n)
    # the generator moves on as far as without remat
    assert torch.equal(s0, s1)
    # the hazard the replay covers: a bare checkpoint redraws the masks
    _, g2, _ = _dropout_grads(True, ids, lbl, replay=False)
    name = "inner.gpt.h.0.mlp.fc_in.weight"
    assert not torch.allclose(g2[name], g0[name], rtol=1e-3, atol=1e-6)


def test_remat_trainer_step_with_dropout_equals_the_plain_step():
    ids, lbl = _batch()
    params = []
    for remat in (False, True):
        _, port = _pair(attn_dropout=0.1, hidden_dropout=0.1)
        tr = ParallelTrainer(_loss_layer(tnn.Layer, port, "pallas"),
                             AdamW(3e-4), lambda out, _l: out, device="cpu",
                             remat=remat)
        framework.seed(9)
        for _ in range(2):
            tr.train_step((ids, lbl), 0.0)
        params.append({n: tr.get_param(n) for n in tr.params})
    for n in params[0]:
        torch.testing.assert_close(params[1][n], params[0][n], rtol=1e-5,
                                   atol=1e-7, msg=n)


def test_lr_scheduler_drives_train_step():
    ref, port = _pair()
    ids, lbl = _batch()
    ref_sched = ref_lr.LinearWarmup(ref_lr.CosineAnnealingDecay(3e-4, 10),
                                    2, 0.0, 3e-4)
    port_sched = port_lr.LinearWarmup(port_lr.CosineAnnealingDecay(3e-4, 10),
                                      2, 0.0, 3e-4)
    ref_opt = paddle.optimizer.AdamW(ref_sched, parameters=ref.parameters())
    port_opt = AdamW(port_sched)
    assert port_opt.get_lr() == ref_opt.get_lr() == 0.0
    with pytest.raises(RuntimeError, match="LRScheduler"):
        port_opt.set_lr(1e-3)
    ref_tr, port_tr = _fused_trainers(ref, port, ref_opt=ref_opt,
                                      port_opt=port_opt)

    def after():
        ref_sched.step()
        port_sched.step()
        assert port_opt.get_lr() == ref_opt.get_lr()

    # step 0 runs at lr 0 (warm-up start), so the first update is a no-op
    _three_steps(ref_tr, port_tr, (ids, lbl), 0.0, after)


# -- LR schedulers, class by class -------------------------------------------

SCHEDULES = [
    ("NoamDecay", (64, 10), {"learning_rate": 2.0}),
    ("PiecewiseDecay", ([5, 20], [0.1, 0.05, 0.01]), {}),
    ("NaturalExpDecay", (0.5, 0.1), {}),
    ("InverseTimeDecay", (0.5, 0.1), {}),
    ("PolynomialDecay", (0.5, 20), {"end_lr": 0.01, "power": 2.0}),
    ("PolynomialDecay", (0.5, 20), {"cycle": True}),
    ("LinearWarmup", (0.3, 5, 0.0, 0.3), {}),
    ("ExponentialDecay", (0.5, 0.9), {}),
    ("MultiStepDecay", (0.5, [10, 30]), {"gamma": 0.5}),
    ("StepDecay", (0.5, 7), {}),
    ("LambdaDecay", (0.5, lambda e: 0.95 ** e), {}),
    ("CosineAnnealingDecay", (0.5, 25), {"eta_min": 0.01}),
    ("CyclicLR", (0.01, 0.1, 6), {"mode": "triangular2"}),
    ("CyclicLR", (0.01, 0.1, 6), {"mode": "exp_range", "exp_gamma": 0.97}),
    ("OneCycleLR", (0.1, 40), {}),
    ("OneCycleLR", (0.1, 40), {"anneal_strategy": "linear"}),
]


@pytest.mark.parametrize("name,args,kwargs", SCHEDULES)
def test_lr_schedule_matches_the_reference(name, args, kwargs):
    ref = getattr(ref_lr, name)(*args, **kwargs)
    port = getattr(port_lr, name)(*args, **kwargs)
    seq_ref, seq_port = [], []
    for _ in range(50):
        seq_ref.append(ref())
        seq_port.append(port())
        ref.step()
        port.step()
    assert seq_port == seq_ref
    # state_dict round trip: a fresh scheduler resumes where this one is
    again = getattr(port_lr, name)(*args, **kwargs)
    again.set_state_dict(port.state_dict())
    assert again.state_dict() == port.state_dict()
    for _ in range(5):
        again.step()
        port.step()
        assert again() == port()


def test_lr_warmup_over_a_schedule_and_reduce_on_plateau():
    ref = ref_lr.LinearWarmup(ref_lr.StepDecay(0.5, 4), 3, 0.0, 0.5)
    port = port_lr.LinearWarmup(port_lr.StepDecay(0.5, 4), 3, 0.0, 0.5)
    for _ in range(20):
        assert port() == ref()
        ref.step()
        port.step()
    ref = ref_lr.ReduceOnPlateau(0.1, patience=2, cooldown=1)
    port = port_lr.ReduceOnPlateau(0.1, patience=2, cooldown=1)
    metrics = [5, 4, 4, 4, 4, 4, 3, 3, 3, 3, 3, 3, 3, 2]
    for m in metrics:
        ref.step(m)
        port.step(m)
        assert port() == ref()
    assert port() < 0.1
    again = port_lr.ReduceOnPlateau(0.1)
    again.set_state_dict(port.state_dict())
    assert again() == port() and again.num_bad_epochs == port.num_bad_epochs
    with pytest.raises(NotImplementedError):
        port_lr.LRScheduler(0.1)


# -- regularizers ------------------------------------------------------------

@pytest.mark.parametrize("decay", [("L1Decay", 0.05), ("L2Decay", 0.05),
                                   (None, 0.05)])
@pytest.mark.parametrize("opt_name", ["Adam", "AdamW"])
def test_regularizers_match_the_reference(opt_name, decay):
    import jax.numpy as jnp
    from paddle_tpu import regularizer as ref_reg
    kind, coeff = decay
    rs = np.random.RandomState(11)
    params = {f"p{i}": rs.randn(*s).astype(np.float32)
              for i, s in enumerate([(4, 3), (7,)])}
    grads = {k: rs.randn(*v.shape).astype(np.float32)
             for k, v in params.items()}
    ref_wd = getattr(ref_reg, kind)(coeff) if kind else coeff
    port_wd = getattr(regularizer, kind)(coeff) if kind else coeff
    ref_opt = getattr(paddle.optimizer, opt_name)(1e-2, weight_decay=ref_wd)
    port_opt = {"Adam": Adam, "AdamW": AdamW}[opt_name](1e-2,
                                                        weight_decay=port_wd)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    want, _ = ref_opt.apply_gradients(
        jp, {k: jnp.asarray(v) for k, v in grads.items()},
        ref_opt.init_state(jp))
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    got, state = port_opt.apply_gradients(
        tp, {k: torch.from_numpy(v) for k, v in grads.items()},
        port_opt.init_state(tp))
    assert int(state["step"]) == 1
    for k in params:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
