"""The port's AMP (``auto_cast``, ``decorate``, ``GradScaler``) against the JAX
package's, on the CPU.

- ``GradScaler``: the functional state (``update_scale_state``) and the
  imperative ``update`` give the reference's scale and good/bad counters
  after every step of a fixed finite/non-finite sequence, exactly (powers
  of two and integer counts).
- ``auto_cast`` on ``linear``: white-listed, the product comes out in
  bfloat16 on both sides (values rtol 1e-2: one bfloat16 rounding of a
  float32-accumulated product); black-listed, it stays float32 and equals
  the reference's to rtol 1e-6.
- ``decorate`` at O2 casts the same parameters as the reference's (all but
  the norms').
- ``ParallelTrainer(scaler=)`` on a depth-1 narrow GPT under
  ``auto_cast(dtype="bfloat16")`` with float32 master weights, five steps
  with the third tainted by ``grad_taint=inf``: the skip count and the
  scale after each step equal the reference's and the values
  ``chip_smoke.py`` requires on the card (``AMP_SCALES``); the tainted
  step leaves every weight as it was, bit for bit, on both sides, and
  every other step changes every weight tensor; losses rtol 1e-2
  (bfloat16 products rounded in the two frameworks' own ways). What the
  four applied updates moved, ``port - start`` against ``reference -
  start`` over all weights, within 0.1 in relative L2 norm (read: 0.029;
  a run that never applies an update reads 1.0), and Adam's ``m`` and
  ``v`` within 0.05 (read: 0.004 and 0.006; gradients left scaled put
  the loss scale into ``m`` and its square into ``v``): the update is held under the scaler, where the
  weights alone are not (4 AdamW steps of lr 3e-4 move an element by at
  most ~1.2e-3, and Adam's step hardly depends on the gradient's scale).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as ref_amp
from paddle_tpu import nn as rnn
from paddle_tpu.distributed.engine import ParallelTrainer as RefTrainer
from paddle_tpu.text.models import GPTForPretraining as RefGPT
from paddle_tpu.text.models import gpt_tiny
from tools._mesh_setup import data_mesh

import chip_smoke
from paddle_tpu_torch import amp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.distributed.engine import ParallelTrainer
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.text.models import GPTForPretraining

FOUND = [False, False, True, False, False, False, True, True, False, False,
         False]


@pytest.mark.parametrize("kw", [
    dict(init_loss_scaling=1024.0, incr_every_n_steps=2,
         decr_every_n_nan_or_inf=1),
    dict(init_loss_scaling=2.0 ** 15, incr_every_n_steps=3,
         decr_every_n_nan_or_inf=2, decr_ratio=0.25),
    dict(init_loss_scaling=4.0, incr_every_n_steps=1,
         decr_every_n_nan_or_inf=1, decr_ratio=0.125)])
def test_grad_scaler_state_step_by_step(kw):
    ref, port = ref_amp.GradScaler(**kw), amp.GradScaler(**kw)
    r_state, p_state = ref.init_scale_state(), port.init_scale_state()
    ref_i, port_i = ref_amp.GradScaler(**kw), amp.GradScaler(**kw)
    for step, found in enumerate(FOUND):
        r_state = ref.update_scale_state(r_state, jnp.asarray(found))
        p_state = port.update_scale_state(p_state, torch.tensor(found))
        for key in ("scale", "good", "bad"):
            assert float(p_state[key]) == float(r_state[key]), (step, key)
        assert p_state["good"].dtype == torch.int32
        ref_i.update(found)
        port_i.update(found)
        assert port_i.state_dict() == ref_i.state_dict(), step
    # the scale floor of 1.0
    low = amp.GradScaler(init_loss_scaling=1.0, decr_every_n_nan_or_inf=1)
    st = low.update_scale_state(low.init_scale_state(), torch.tensor(True))
    assert float(st["scale"]) == 1.0


def test_unscale_and_update_matches():
    rs = np.random.RandomState(0)
    g = {"a": rs.randn(5).astype(np.float32) * 1024,
         "b": rs.randn(3).astype(np.float32) * 1024}
    kw = dict(init_loss_scaling=1024.0, incr_every_n_steps=1)
    ref, port = ref_amp.GradScaler(**kw), amp.GradScaler(**kw)
    r_un, r_found, r_st = ref.unscale_and_update(
        {k: jnp.asarray(v) for k, v in g.items()}, ref.init_scale_state())
    p_un, p_found, p_st = port.unscale_and_update(
        {k: torch.from_numpy(v) for k, v in g.items()},
        port.init_scale_state())
    for k in g:
        np.testing.assert_array_equal(p_un[k].numpy(), np.asarray(r_un[k]))
    assert bool(p_found) == bool(r_found) is False
    assert float(p_st["scale"]) == float(r_st["scale"]) == 2048.0
    g["a"][2] = np.inf
    _, p_found, _ = port.unscale_and_update(
        {k: torch.from_numpy(v) for k, v in g.items()},
        port.init_scale_state())
    assert bool(p_found)


def _linear_pair():
    rs = np.random.RandomState(1)
    x = rs.randn(6, 16).astype(np.float32)
    w = rs.randn(16, 8).astype(np.float32)
    b = rs.randn(8).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("black", [False, True])
def test_auto_cast_white_and_black_lists_on_linear(black):
    x, w, b = _linear_pair()
    kw = dict(custom_black_list=["linear"]) if black else {}
    with ref_amp.auto_cast(**kw):
        want = rnn.functional.linear(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b))
        assert ref_amp.should_cast("linear") is not black
    with amp.auto_cast(**kw):
        got = tnn.functional.linear(torch.from_numpy(x), torch.from_numpy(w),
                                    torch.from_numpy(b))
        assert amp.should_cast("linear") is not black
    assert not amp.should_cast("linear")         # restored on exit
    if black:
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    else:
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want).astype(np.float32),
                                   rtol=1e-2, atol=1e-2)
    with amp.auto_cast(custom_white_list=["my_op"]):
        assert amp.should_cast("my_op") and amp.should_cast("matmul")
        assert not amp.should_cast("softmax")
    with amp.auto_cast(dtype="float16"):
        assert amp.amp_dtype() == torch.float16
        assert amp.cast_if_amp("linear", torch.ones(2))[0].dtype == \
            torch.float16
    assert amp.cast_if_amp("linear", torch.ones(2))[0].dtype == torch.float32


CFG = dict(tensor_parallel=False, attn_dropout=0.0, hidden_dropout=0.0,
           **gpt_tiny(num_layers=1))


def _pair():
    paddle.seed(0)
    ref = RefGPT(**CFG)
    port = GPTForPretraining(**CFG)
    port.set_state_dict_from_numpy(
        {k: np.asarray(v) for k, v in ref.state_dict().items()})
    return ref, port


def test_decorate_o2_casts_what_the_reference_casts():
    ref, port = _pair()
    ref_amp.decorate(ref, level="O2")
    assert amp.decorate(port, level="O2") is port
    want = {k: np.dtype(v.dtype).name for k, v in ref.state_dict().items()}
    got = {k: str(v.dtype).split(".")[-1]
           for k, v in port.named_state().items()}
    assert got == want
    assert got["gpt.ln_f.weight"] == "float32"
    assert got["gpt.h.0.attn.qkv_proj.weight"] == "bfloat16"


class _RefLoss(rnn.Layer):
    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, batch):
        ids, lbl = batch
        return self.inner.fused_head_loss(ids, lbl, chunk=384,
                                          ce_kernel="chunked")


class _PortLoss(tnn.Layer):
    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, batch):
        ids, lbl = batch
        return self.inner.fused_head_loss(ids, lbl, chunk=384,
                                          ce_kernel="chunked")


def test_trainer_with_a_scaler_and_a_tainted_step_matches():
    ref, port = _pair()
    data_mesh(1)
    rs = np.random.RandomState(3)
    batch = (rs.randint(0, 1024, (2, 64)).astype(np.int32),
             rs.randint(0, 1024, (2, 64)).astype(np.int32))
    ref_tr = RefTrainer(_RefLoss(ref),
                        paddle.optimizer.AdamW(3e-4,
                                               parameters=ref.parameters()),
                        lambda out, _l: out,
                        scaler=ref_amp.GradScaler(**chip_smoke.AMP_SCALER))
    port_tr = ParallelTrainer(_PortLoss(port), AdamW(3e-4),
                              lambda out, _l: out, device="cpu",
                              scaler=amp.GradScaler(**chip_smoke.AMP_SCALER))
    names = list(port_tr.params)

    def weights():
        return ({k: port_tr.get_param(k).numpy().copy() for k in names},
                {k: np.asarray(ref_tr.get_param(k)).copy() for k in names})

    start = weights()
    r_scales, p_scales, r_loss, p_loss = [], [], [], []
    for step in range(len(chip_smoke.AMP_SCALES)):
        taint = float("inf") if step in chip_smoke.AMP_TAINTED else None
        before = weights()
        with ref_amp.auto_cast(dtype="bfloat16"):
            r_loss.append(float(ref_tr.train_step(batch, 0.0,
                                                  grad_taint=taint)))
        with amp.auto_cast(dtype="bfloat16"):
            p_loss.append(float(port_tr.train_step(batch, 0.0,
                                                   grad_taint=taint)))
        r_scales.append(float(ref_tr.state["guard"]["amp"]["scale"]))
        p_scales.append(port_tr.loss_scale())
        after = weights()
        for side in (0, 1):         # a skipped step restores every bit
            for k in names:
                same = np.array_equal(after[side][k], before[side][k])
                assert same == (taint is not None), (step, side, k)
    assert r_scales == list(chip_smoke.AMP_SCALES)
    assert p_scales == r_scales
    assert port_tr.skipped_steps() == ref_tr.skipped_steps() == \
        len(chip_smoke.AMP_TAINTED)
    np.testing.assert_allclose(p_loss, r_loss, rtol=1e-2)
    # float32 master weights, bfloat16 products
    name = "inner.gpt.h.0.attn.qkv_proj.weight"
    assert port_tr.get_param(name).dtype == torch.float32
    # what the four applied updates moved, and Adam's moments: a step
    # never applied gives 1.0 on the weights; gradients left scaled put
    # the loss scale into the moments
    assert _rel_change(after[0], start[0], after[1], start[1], names) <= 0.1
    for slot in ("m", "v"):
        got = {k: port_tr.get_opt_slot(k, slot).numpy() for k in names}
        want = {k: np.asarray(ref_tr.state["opt"]["slots"][k][slot])
                for k in names}
        assert _rel(got, want, names) <= 0.05, slot


def _rel(got, want, names):
    """||got - want|| / ||want|| over every tensor in ``names``."""
    g = np.concatenate([np.ravel(got[k]) for k in names])
    w = np.concatenate([np.ravel(want[k]) for k in names])
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def _rel_change(got, got0, want, want0, names):
    return _rel({k: got[k] - got0[k] for k in names},
                {k: want[k] - want0[k] for k in names}, names)
