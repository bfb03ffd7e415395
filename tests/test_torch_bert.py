"""The port's BERT/ERNIE (``paddle_tpu_torch/text/models/bert.py``) against
the JAX package's, on the CPU.

Tiny widths (vocab 128, hidden 32, 2 layers, 4 heads, S 16, dropout 0),
the reference's weights carried over with ``set_state_dict_from_numpy``.
Tolerances, each where it is asserted:

- a forward, the loss and the gradients in float32: the same products
  summed in another order (PyTorch's CPU GEMM against XLA's dot): rtol
  1e-5, atol 1e-5 (the largest values are O(1)).
- three AdamW trainer steps: the losses rtol 1e-5 and each parameter
  within ``STEP_ATOL`` = 2e-6, the fp32 trainer's bar of
  ``test_torch_zero.py``. The key part of each ``qkv_proj`` bias is
  compared apart: softmax cancels it (it adds the same logit to every
  key of a query), so its gradient is rounding noise and AdamW turns the
  noise's sign into steps of up to lr; it is held to moving less than
  ``STEPS * LR``, as ``test_torch_tensor_parallel.py`` reasons.
- ``tensor_parallel=True`` at ``{"model": 2}`` (a gloo world of 2,
  ``torch_bert_worker.py``): the same bars against the dense port and the
  reference; the vocab-split logits, the split decoder bias and the model
  axis's sums change only the order of float32 sums.
- bf16: ``model.bfloat16()`` against the float32 model, rtol 5e-2 of the
  largest value (bf16 keeps 8 bits of mantissa through 2 layers).
- the golden (``testdata/bert_golden.json``, BERT-base widths, depth 2):
  the step-0 loss and gradient norm within rtol 1e-4, the later losses
  within 1e-3, the bars ``chip_smoke.py`` holds the card to.
"""
import json
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.distributed.engine import ParallelTrainer as RefTrainer
from paddle_tpu.distributed.mesh import build_mesh as ref_build_mesh
from paddle_tpu.jit.functionalization import functional_call, state_of
from paddle_tpu.text import models as ref_models

from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.distributed import mesh as mesh_mod
from paddle_tpu_torch.distributed.engine import ParallelTrainer
from paddle_tpu_torch.ops.flash_attention import flash_gate
from paddle_tpu_torch.testdata import recipes
from paddle_tpu_torch.text import models

import torch_hybrid_worker as hybrid
from torch_threads import two_threads  # noqa: F401

CFG = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
           max_position_embeddings=64, attn_dropout=0.0, hidden_dropout=0.0)
B, S = 2, 16
LR = 1e-3
STEPS = 3
STEP_ATOL = 2e-6
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _batch(seed=0):
    return recipes.bert_data(seed, B, S, CFG["vocab_size"])


def _pair(cls="BertForPretraining", **kw):
    paddle.seed(0)
    ref = getattr(ref_models, cls)(tensor_parallel=False, **CFG, **kw)
    port = getattr(models, cls)(tensor_parallel=False, **CFG, **kw)
    w = {k: np.asarray(v) for k, v in ref.state_dict().items()}
    port.set_state_dict_from_numpy(w)
    return ref, port, w


def _close(got, want, rtol=1e-5, atol=1e-5, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_names_forward_loss_and_gradients_against_the_reference():
    ref, port, w = _pair()
    assert list(port.named_state()) == list(w)
    ids, mlm, nsp = _batch()
    tt = (np.arange(S) >= S // 2).astype(np.int32)[None].repeat(B, 0)
    seq_r, pooled_r = ref.bert(ids, tt)
    seq_p, pooled_p = port.bert(_t(ids), _t(tt))
    _close(seq_p.detach(), seq_r, what="sequence")
    _close(pooled_p.detach(), pooled_r, what="pooled")
    (mlm_r, nsp_r), (mlm_p, nsp_p) = ref(ids, tt), port(_t(ids), _t(tt))
    _close(mlm_p.detach(), mlm_r, what="mlm logits")
    _close(nsp_p.detach(), nsp_r, what="nsp logits")
    loss_p = port.loss(mlm_p, nsp_p, _t(mlm), _t(nsp))
    _close(float(loss_p), float(ref.loss(mlm_r, nsp_r, mlm, nsp)),
           what="loss")
    params, buffers = state_of(ref)
    grads = jax.grad(lambda p: ref.loss(*functional_call(
        ref, p, buffers, jnp.asarray(ids), jnp.asarray(tt))[0], mlm,
        nsp))(params)
    names = [n for n, _ in port.named_parameters()]
    got = torch.autograd.grad(loss_p, [p for _, p in
                                       port.named_parameters()])
    for n, g in zip(names, got):
        _close(g, grads[n], what=n)


def test_the_tied_weight_is_one_parameter_whose_gradient_sums_both_uses():
    _, port, w = _pair()
    emb = port.bert.embeddings.word_embeddings.weight
    assert port.cls.decoder_weight is emb
    assert sum(p is emb for p in port.parameters()) == 1
    assert "cls.decoder_weight" not in dict(port.named_parameters())
    # the untied heads on a copy: the tied gradient is the lookup's plus
    # the projection's
    untied = models.BertPretrainingHeads(CFG["hidden_size"],
                                         CFG["vocab_size"],
                                         tensor_parallel=False)
    untied.load_state_dict({k: v for k, v in port.cls.state_dict().items()},
                           strict=False)
    with torch.no_grad():
        untied.decoder_weight.copy_(emb)
    ids, mlm, nsp = (_t(a) for a in _batch())
    tied_g, = torch.autograd.grad(port.loss(*port(ids), mlm, nsp), [emb])
    seq, pooled = port.bert(ids)
    loss = port.loss(*untied(seq, pooled), mlm, nsp)
    g_lookup, g_head = torch.autograd.grad(loss, [emb,
                                                  untied.decoder_weight])
    torch.testing.assert_close(tied_g, g_lookup + g_head, rtol=1e-6,
                               atol=1e-7)
    assert float(g_lookup.abs().sum()) > 0 and float(g_head.abs().sum()) > 0


def _ref_steps(w, ids, mlm, nsp):
    ref_build_mesh({"data": 1})
    paddle.seed(0)
    ref = ref_models.BertForPretraining(tensor_parallel=False, **CFG)
    ref.set_state_dict({k: jnp.asarray(v) for k, v in w.items()})
    rt = RefTrainer(ref, paddle.optimizer.AdamW(
        LR, parameters=ref.parameters()), lambda o, lb: ref.loss(*o, *lb))
    losses = [float(rt.train_step(ids, (mlm, nsp))) for _ in range(STEPS)]
    return losses, {k: np.asarray(v) for k, v in rt.state["params"].items()}


def _port_steps(w, ids, mlm, nsp):
    mesh_mod.set_mesh(None)
    mesh_mod.build_mesh({"data": 1})
    port = models.BertForPretraining(tensor_parallel=False, **CFG)
    port.set_state_dict_from_numpy(w)
    pt = ParallelTrainer(port, topt.AdamW(LR),
                         lambda o, lb: port.loss(*o, *lb), device="cpu")
    losses = [float(pt.train_step(_t(ids), (_t(mlm), _t(nsp))))
              for _ in range(STEPS)]
    return losses, {k: p.detach().numpy().copy()
                    for k, p in pt.params.items()}


def _held(got, want, w):
    hd = CFG["hidden_size"] // CFG["num_heads"]
    for k, v in want.items():
        g = got[k]
        if k.endswith("qkv_proj.bias"):
            heads = g.reshape(-1, 3, hd)
            wk = v.reshape(-1, 3, hd)
            _close(heads[:, [0, 2]], wk[:, [0, 2]], rtol=0, atol=STEP_ATOL,
                   what=k)
            moved = np.abs(heads[:, 1] - w[k].reshape(-1, 3, hd)[:, 1])
            assert moved.max() <= STEPS * LR * 1.01, k
        else:
            _close(g, v, rtol=0, atol=STEP_ATOL, what=k)


def test_three_adamw_trainer_steps_against_the_reference():
    _, _, w = _pair()
    ids, mlm, nsp = _batch(1)
    rl, rp = _ref_steps(w, ids, mlm, nsp)
    pl, pp = _port_steps(w, ids, mlm, nsp)
    _close(pl, rl, rtol=1e-5, atol=0, what="losses")
    assert pl[-1] < pl[0]
    _held(pp, rp, w)


def test_bidirectional_token_types_classification_and_bf16():
    _, port, _ = _pair()
    port.eval()
    ids = torch.ones(1, 8, dtype=torch.long)
    ids2 = ids.clone()
    ids2[0, 7] = 5
    assert not torch.equal(port.bert(ids)[0][0, 0], port.bert(ids2)[0][0, 0])
    s1 = port.bert(ids, torch.zeros_like(ids))[0]
    s2 = port.bert(ids, torch.ones_like(ids))[0]
    assert not torch.allclose(s1, s2)
    assert models.ErnieModel is models.BertModel
    assert models.ErnieForPretraining is models.BertForPretraining
    assert models.bert_base()["hidden_size"] == 768
    assert models.bert_large(num_layers=2)["num_layers"] == 2
    ref, clf, _ = _pair("BertForSequenceClassification", num_classes=3)
    clf.eval()
    ref.eval()
    ids, _, _ = _batch()
    _close(clf(_t(ids)).detach(), ref(ids), what="classifier")
    full = port(_t(ids))
    port.bfloat16()
    half = port(_t(ids))
    for a, b in zip(half, full):
        assert a.dtype == torch.bfloat16
        scale = float(b.abs().max())
        _close(a.float().detach(), b.detach(), rtol=0, atol=5e-2 * scale)
    loss = port.loss(*half, _t(_batch()[1]), _t(_batch()[2]))
    assert loss.dtype == torch.float32 and torch.isfinite(loss)


def test_flash_gate_takes_bert_at_512_and_refuses_128():
    assert flash_gate("cuda", torch.bfloat16, (16, 512, 12, 64), 512)
    assert not flash_gate("cuda", torch.bfloat16, (16, 128, 12, 64), 512)
    assert not flash_gate("cpu", torch.bfloat16, (16, 512, 12, 64), 512)


@pytest.mark.multihost(timeout=300)
def test_tensor_parallel_at_model_2_against_dense_and_reference(
        tmp_path_factory):
    from paddle_tpu_torch.distributed.spawn import spawn
    import torch_bert_worker
    _, _, w = _pair()
    ids, mlm, nsp = _batch(1)
    d = tmp_path_factory.mktemp("bert_tp")
    with open(d / "plan.pkl", "wb") as f:
        pickle.dump({"cfg": CFG, "weights": w, "batch": (ids, mlm, nsp),
                     "lr": LR, "steps": STEPS}, f)
    spawn(torch_bert_worker.main, args=(str(d / "plan.pkl"), str(d)),
          nprocs=2, timeout=240)
    ranks = []
    for r in range(2):
        with open(d / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    rl, rp = _ref_steps(w, ids, mlm, nsp)
    pl, pp = _port_steps(w, ids, mlm, nsp)
    splits = dict(ranks[0]["train"]["bert"]["params"])
    assert splits["bert.embeddings.word_embeddings.weight"][1] == \
        (("model", 0),)
    assert splits["cls.decoder_bias"][1] == (("model", 0),)
    tp = {k: hybrid.assemble(ranks, "bert", k) for k in pp}
    for r in ranks:
        assert r["train"]["bert"]["skipped"] == 0
        _close(r["train"]["bert"]["losses"], rl, rtol=1e-5, atol=0,
               what="tp losses against the reference")
        _close(r["train"]["bert"]["losses"], pl, rtol=1e-5, atol=0,
               what="tp losses against the dense port")
    _held(tp, rp, w)
    _held(tp, pp, w)


def test_the_golden_on_the_cpu():
    """The port rebuilt from the golden's recipe: its step-0 loss and
    gradient norm, and three trainer steps, against the JAX package's."""
    with open(os.path.join(ROOT, "paddle_tpu_torch", "testdata",
                           "bert_golden.json")) as f:
        gold = json.load(f)
    cfg = {k: v for k, v in gold["config"].items()
           if k not in ("dtype", "batch", "seq")}
    torch.manual_seed(0)
    model = models.BertForPretraining(tensor_parallel=False, **cfg)
    names_shapes = [(n, tuple(t.shape)) for n, t in
                    model.named_state().items()]
    assert [[n, list(s)] for n, s in names_shapes] == gold["names_shapes"]
    rw = gold["recipe"]["weights"]
    model.set_state_dict_from_numpy(recipes.bert_weights(
        names_shapes, rw["seed"], rw["std"]))
    ids, mlm, nsp = (_t(a) for a in recipes.bert_data(
        gold["recipe"]["data"]["seed"], gold["config"]["batch"],
        gold["config"]["seq"], cfg["vocab_size"]))
    loss = model.loss(*model(ids), mlm, nsp)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    gnorm = float(torch.sqrt(sum(g.double().square().sum() for g in grads)))
    _close(float(loss), gold["losses"][0], rtol=1e-4, atol=0)
    _close(gnorm, gold["step0_grad_norm"], rtol=1e-4, atol=0)
    mesh_mod.set_mesh(None)
    mesh_mod.build_mesh({"data": 1})
    tr = ParallelTrainer(model, topt.AdamW(gold["optimizer"]
                                           ["learning_rate"]),
                         lambda o, lb: model.loss(*o, *lb), device="cpu")
    losses = [float(tr.train_step(ids, (mlm, nsp)))
              for _ in gold["losses"]]
    _close(losses[0], gold["losses"][0], rtol=1e-4, atol=0)
    _close(losses[1:], gold["losses"][1:], rtol=1e-3, atol=0)
