"""GPT training in the PyTorch port against the JAX package, on the CPU.

The reference model's ``state_dict()`` is loaded into the port at
``gpt_tiny`` widths (vocab 1024, hidden 128, 2 layers, 4 heads; seq 64,
batch 2, no dropout). On the CPU both sides take the plain attention (the
flash gate needs the card, or a TPU for the reference). Tolerances:

- ``fused_head_loss`` (chunk 384, so the last chunk is padded in the
  reference and narrower in the port) loss and every gradient: float32
  atol 1e-5, rtol 1e-4 (sums taken in different orders);
- three AdamW ``ParallelTrainer`` steps: losses rtol 1e-4, params atol 5e-5
  (Adam's normalized step amplifies last-bit gradient differences);
- the same in bfloat16 for two steps: loss rtol 1e-2 (the two frameworks
  round bfloat16 products at different places).

The golden test recomputes the step-0 loss of
``paddle_tpu_torch/testdata/gpt_train_golden.json`` (GPT-base widths,
depth 2) with both packages, forward only, and holds each against the file.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as rnn
from paddle_tpu.distributed.engine import ParallelTrainer as RefTrainer
from paddle_tpu.jit.functionalization import functional_call, state_of
from paddle_tpu.text.models import GPTForPretraining as RefGPT
from paddle_tpu.text.models import gpt_tiny
from tools._mesh_setup import data_mesh

import torch_gpt_train_golden as golden
from paddle_tpu_torch import framework
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import telemetry
from paddle_tpu_torch.distributed.engine import ParallelTrainer
from paddle_tpu_torch.nn.functional import dropout, fused_linear_cross_entropy
from paddle_tpu_torch.ops import tuner
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.text.models import GPTForPretraining

BATCH, SEQ, CHUNK = 2, 64, 384
CFG = dict(tensor_parallel=False, attn_dropout=0.0, hidden_dropout=0.0,
           **gpt_tiny())


def _ref_loss_layer(model, chunk=CHUNK):
    class FusedLoss(rnn.Layer):
        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def forward(self, batch):
            ids, lbl = batch
            return self.inner.fused_head_loss(ids, lbl, chunk=chunk,
                                              ce_kernel="chunked")

    return FusedLoss(model)


def _port_loss_layer(model, chunk=CHUNK):
    class FusedLoss(tnn.Layer):
        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def forward(self, batch):
            ids, lbl = batch
            return self.inner.fused_head_loss(ids, lbl, chunk=chunk,
                                              ce_kernel="chunked")

    return FusedLoss(model)


def _numpy_state(model):
    return {k: np.asarray(v) for k, v in model.state_dict().items()}


def _pair():
    paddle.seed(0)
    ref = RefGPT(**CFG)
    port = GPTForPretraining(**CFG)
    port.set_state_dict_from_numpy(_numpy_state(ref))
    return ref, port


def _batch(seed=3):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, 1024, (BATCH, SEQ)).astype(np.int32)
    lbl = rs.randint(0, 1024, (BATCH, SEQ)).astype(np.int32)
    return ids, lbl


def _trainers(ref, port):
    data_mesh(1)
    ref_tr = RefTrainer(_ref_loss_layer(ref),
                        paddle.optimizer.AdamW(3e-4,
                                               parameters=ref.parameters()),
                        lambda out, _l: out)
    port_tr = ParallelTrainer(_port_loss_layer(port), AdamW(3e-4),
                              lambda out, _l: out, device="cpu")
    return ref_tr, port_tr


def test_state_names_and_shapes_match_the_reference():
    ref, port = _pair()
    ref_state = _numpy_state(ref)
    port_state = port.named_state()
    assert list(port_state) == list(ref_state)
    assert "gpt.embeddings.word_embeddings.weight" in port_state
    assert not any(n.startswith("lm_head") for n in port_state)
    for name, v in ref_state.items():
        assert tuple(port_state[name].shape) == v.shape, name
        np.testing.assert_array_equal(port_state[name].detach().numpy(), v)
    # the head reads the tied embedding weight
    assert port.lm_head.weight is port.gpt.embeddings.word_embeddings.weight
    bad = dict(ref_state)
    bad.pop("gpt.ln_f.bias")
    with pytest.raises(ValueError, match="missing"):
        port.set_state_dict_from_numpy(bad)
    bad = dict(ref_state, extra=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="unexpected"):
        port.set_state_dict_from_numpy(bad)


def test_fused_head_loss_and_grads_match_the_reference():
    ref, port = _pair()
    ids, lbl = _batch()
    wrapped = _ref_loss_layer(ref)
    params, buffers = state_of(wrapped)
    loss, grads = jax.value_and_grad(
        lambda p: functional_call(wrapped, p, buffers, (ids, lbl))[0])(params)
    pw = _port_loss_layer(port)
    ploss = pw((torch.from_numpy(ids), torch.from_numpy(lbl)))
    ploss.backward()
    np.testing.assert_allclose(ploss.item(), float(loss), rtol=1e-4,
                               atol=1e-5)
    pgrads = dict(pw.named_parameters())
    assert set(pgrads) == set(grads)
    for name, g in grads.items():
        np.testing.assert_allclose(pgrads[name].grad.numpy(), np.asarray(g),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_three_adamw_steps_match_the_reference():
    ref, port = _pair()
    ref_tr, port_tr = _trainers(ref, port)
    batch = _batch()
    for step in range(3):
        lr_ = float(ref_tr.train_step(batch, 0.0))
        lp = float(port_tr.train_step(batch, 0.0))
        np.testing.assert_allclose(lp, lr_, rtol=1e-4, err_msg=f"step {step}")
    assert set(port_tr.params) == set(ref_tr.state["params"])
    for name in port_tr.params:
        got = port_tr.get_param(name).numpy()
        want = np.asarray(ref_tr.get_param(name))
        if name.endswith("attn.qkv_proj.bias"):
            # the key bias adds q.b_k to every score of a row, which the
            # softmax cancels: its true gradient is 0, and what each side
            # computes is rounding noise that Adam scales up to +-lr.
            # Compare the query and value parts (per-head interleaved).
            heads, hd = CFG["num_heads"], CFG["hidden_size"] // CFG["num_heads"]
            got = got.reshape(heads, 3, hd)[:, [0, 2]]
            want = want.reshape(heads, 3, hd)[:, [0, 2]]
        np.testing.assert_allclose(got, want, atol=5e-5, err_msg=name)
    assert int(port_tr.opt_state["step"]) == 3
    assert port_tr.skipped_steps() == 0 and ref_tr.skipped_steps() == 0


def test_bfloat16_steps_match_the_reference():
    ref, port = _pair()
    ref.bfloat16()
    port.bfloat16()
    assert all(p.dtype == torch.bfloat16 for p in port.parameters())
    ref_tr, port_tr = _trainers(ref, port)
    batch = _batch()
    for step in range(2):
        lr_ = float(ref_tr.train_step(batch, 0.0))
        lp = float(port_tr.train_step(batch, 0.0))
        np.testing.assert_allclose(lp, lr_, rtol=1e-2, err_msg=f"step {step}")
    # params stay bfloat16, no master copy; the moments are float32
    name = "inner.gpt.h.0.attn.qkv_proj.weight"
    assert port_tr.get_param(name).dtype == torch.bfloat16
    assert port_tr.get_opt_slot(name, "m").dtype == torch.float32


def _snapshot_port(tr):
    return ({n: p.detach().clone() for n, p in tr.params.items()},
            {n: {k: v.clone() for k, v in s.items()}
             for n, s in tr.opt_state["slots"].items()},
            int(tr.opt_state["step"]))


def test_nan_grad_skips_the_step_on_both_sides():
    ref, port = _pair()
    ref_tr, port_tr = _trainers(ref, port)
    batch = _batch()
    ref_tr.train_step(batch, 0.0)
    port_tr.train_step(batch, 0.0)
    params0, slots0, step0 = _snapshot_port(port_tr)
    ref0 = jax.tree_util.tree_map(np.asarray, (ref_tr.state["params"],
                                               ref_tr.state["opt"]))
    ref_tr.train_step(batch, 0.0, grad_taint=float("nan"))
    port_tr.train_step(batch, 0.0, grad_taint=float("nan"))
    assert port_tr.skipped_steps() == 1 and ref_tr.skipped_steps() == 1
    params1, slots1, step1 = _snapshot_port(port_tr)
    assert step1 == step0 == 1
    for n in params0:
        assert torch.equal(params0[n], params1[n]), n
        for k in slots0[n]:
            assert torch.equal(slots0[n][k], slots1[n][k]), (n, k)
    ref1 = jax.tree_util.tree_map(np.asarray, (ref_tr.state["params"],
                                               ref_tr.state["opt"]))
    jax.tree_util.tree_map(np.testing.assert_array_equal, ref0, ref1)
    # and the next clean step applies again
    port_tr.train_step(batch, 0.0)
    assert int(port_tr.opt_state["step"]) == 2
    assert port_tr.skipped_steps() == 1


def test_seed_reproduces_dropout_and_kernel_seeds():
    x = torch.ones(64, 256)
    framework.seed(11)
    a, s1 = dropout(x, p=0.25), framework.draw_seed("cpu")
    framework.seed(11)
    b, s2 = dropout(x, p=0.25), framework.draw_seed("cpu")
    assert torch.equal(a, b) and torch.equal(s1, s2)
    assert s1.dtype == torch.int32 and 0 <= int(s1) < 2 ** 31 - 1
    kept = a != 0
    assert torch.equal(a[kept], torch.full_like(a[kept], 1 / 0.75))
    assert abs(kept.float().mean().item() - 0.75) < 0.02
    assert not torch.equal(a, dropout(x, p=0.25))      # the stream moves on
    assert torch.equal(dropout(x, p=0.25, training=False), x)
    assert torch.equal(dropout(x, p=1.0), torch.zeros_like(x))


def test_trainer_records_step_time_and_tokens_per_sec():
    _, port = _pair()
    tr = ParallelTrainer(_port_loss_layer(port), AdamW(3e-4),
                         lambda out, _l: out, device="cpu")
    reg = telemetry.get_registry()
    reg.reset()
    tr.train_step(_batch(), 0.0)           # telemetry off: nothing recorded
    assert reg.get("step_time_seconds") is None
    telemetry.enable()
    try:
        tr.train_step(_batch(), 0.0)
        tr.train_step(_batch(), 0.0)
    finally:
        telemetry.disable()
    hist = reg.get("step_time_seconds")
    assert hist.count() == 2 and hist.sum() > 0
    assert reg.get("tokens_per_sec").value() > 0
    reg.reset()


def test_trainer_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, port = _pair()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ParallelTrainer(_port_loss_layer(port), AdamW(3e-4),
                        lambda out, _l: out)


@pytest.mark.parametrize("kwargs", [dict(mesh_axis="pipe"),
                                    dict(mesh_axis="model"),
                                    dict(zero_stage=2),
                                    dict(micro_batches=2),
                                    dict(zero_stage=1, grad_sync="int8"),
                                    dict(integrity_check_every=5),
                                    dict(mesh_axis="sep")])
def test_trainer_options_that_wait_raise(kwargs):
    """What still waits in ROADMAP.md raises there: mesh axes other than
    data, ZeRO, pipeline micro-batches and the integrity check (data
    parallelism, the grad_sync policies and the loss scaler are ported:
    ``test_trainer_options_ported_since_build``)."""
    from paddle_tpu_torch.distributed.mesh import build_mesh
    _, port = _pair()
    kwargs = dict(kwargs)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if "mesh_axis" in kwargs:
            kwargs["mesh"] = build_mesh({kwargs.pop("mesh_axis"): 2})
        ParallelTrainer(_port_loss_layer(port), AdamW(3e-4),
                        lambda out, _l: out, device="cpu", **kwargs)


@pytest.mark.parametrize("kwargs,policy", [
    (dict(grad_sync="int8"), "int8"), (dict(fp16_allreduce=True), "bf16"),
    (dict(grad_sync="bf16"), "bf16"), (dict(grad_sync="int4"), "int4"),
    (dict(scaler="scaler"), "fp32"), (dict(mesh="data1"), "fp32")])
def test_trainer_options_ported_since_build(kwargs, policy):
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.distributed.mesh import build_mesh
    _, port = _pair()
    kwargs = dict(kwargs)
    if "scaler" in kwargs:
        kwargs["scaler"] = GradScaler(init_loss_scaling=8.0)
    if "mesh" in kwargs:
        kwargs["mesh"] = build_mesh({"data": 1})
    tr = ParallelTrainer(_port_loss_layer(port), AdamW(3e-4),
                         lambda out, _l: out, device="cpu", **kwargs)
    assert tr.grad_sync == policy
    assert bool(tr.comm_err) == (policy in ("int8", "int4"))
    loss = tr.train_step(_batch(), 0.0)
    assert np.isfinite(float(loss)) and tr.skipped_steps() == 0


def test_adamw_decay_selection_waits():
    """AdamW's ``apply_decay_param_fun`` (no longer waiting): names it
    rejects take no decoupled decay."""
    zero = {"w": torch.zeros(2, 2), "bias": torch.zeros(2)}
    ones = {"w": torch.ones(2, 2), "bias": torch.ones(2)}
    opt = AdamW(0.5, weight_decay=0.1,
                apply_decay_param_fun=lambda name: "bias" not in name)
    new, _ = opt.apply_gradients(ones, zero, opt.init_state(ones))
    assert torch.all(new["w"] == 1.0 - 0.5 * 0.1)
    assert torch.all(new["bias"] == 1.0)


def test_unported_paths_raise_and_auto_counts_the_fallback():
    with pytest.raises(NotImplementedError, match="hybrid"):
        GPTForPretraining(tensor_parallel=True, **gpt_tiny())
    h = torch.randn(4, 8)
    w = torch.randn(8, 16)
    y = torch.tensor([1, 2, 3, -100])
    want = torch.nn.functional.cross_entropy(h @ w, y, ignore_index=-100)
    n0 = tuner.FALLBACKS["fused_ce"]
    # the fused kernels' plain versions on CPU tensors, counted as nothing
    pallas = fused_linear_cross_entropy(h, w, y, kernel="pallas")
    assert tuner.FALLBACKS["fused_ce"] == n0
    torch.testing.assert_close(pallas, want, rtol=1e-5, atol=1e-6)
    auto = fused_linear_cross_entropy(h, w, y, kernel="auto")
    assert tuner.FALLBACKS["fused_ce"] == n0 + 1
    torch.testing.assert_close(auto, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name,args", [("ClipGradByValue", (0.5,)),
                                       ("ClipGradByNorm", (0.3,)),
                                       ("ClipGradByGlobalNorm", (0.7,))])
def test_grad_clips_match_the_reference(name, args):
    rs = np.random.RandomState(5)
    grads = {f"p{i}": rs.randn(*shape).astype(np.float32)
             for i, shape in enumerate([(4, 3), (7,), (2, 2, 5)])}
    grads["frozen"] = None
    want = getattr(paddle.optimizer, name)(*args)(
        {k: None if g is None else jax.numpy.asarray(g)
         for k, g in grads.items()})
    got = getattr(topt, name)(*args)(
        {k: None if g is None else torch.from_numpy(g)
         for k, g in grads.items()})
    assert got["frozen"] is None and want["frozen"] is None
    for k in ("p0", "p1", "p2"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_golden_step0_loss_is_the_reference_and_the_port():
    """GPT-base widths at depth 2: the file's step-0 loss, recomputed."""
    fix = golden.load()
    assert fix["config"] == golden.CONFIG
    assert fix["batch"] == golden.BATCH and fix["seq"] == golden.SEQ
    ref_loss = golden.reference_step0_loss()
    np.testing.assert_allclose(ref_loss, fix["losses"][0], rtol=1e-6)
    model = GPTForPretraining(tensor_parallel=False, **golden.CONFIG)
    names_shapes = [(n, tuple(t.shape)) for n, t in model.named_state().items()]
    assert [[n, list(s)] for n, s in names_shapes] == fix["names_shapes"]
    model.set_state_dict_from_numpy(golden.weights(names_shapes))
    ids, lbl = golden.data()
    with torch.no_grad():
        loss = model.fused_head_loss(torch.from_numpy(ids),
                                     torch.from_numpy(lbl),
                                     chunk=golden.CHUNK, ce_kernel="chunked")
    np.testing.assert_allclose(loss.item(), fix["losses"][0], rtol=1e-4)
