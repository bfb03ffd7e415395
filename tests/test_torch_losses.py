"""The port's loss functionals and layers (``nn/functional/loss.py``,
``nn/layers/loss.py``) against the JAX package's on the same numpy
inputs from a seed, float32: rtol 1e-5, atol 1e-6 (a sum of a few
hundred terms in another order). Every reduction each loss takes is
held; ``ctc_loss`` with repeated labels, blanks, shorter inputs and
``norm_by_times``; ``hsigmoid_loss`` on its default tree and on a custom
path; gradients of the losses with learnable inputs against
``jax.grad``."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu.nn as rnn
import paddle_tpu_torch.nn as pnn

RS = np.random.RandomState(11)
RTOL, ATOL = 1e-5, 1e-6


def _f(*shape):
    return RS.randn(*shape).astype(np.float32)


def _p(*shape):
    return RS.uniform(0.05, 0.95, shape).astype(np.float32)


def _logp(*shape):
    x = RS.randn(*shape).astype(np.float32)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def _to_ref(a):
    return jnp.asarray(a) if isinstance(a, np.ndarray) else a


def _to_port(a):
    return torch.from_numpy(a.copy()) if isinstance(a, np.ndarray) else a


def _check(name, args, kw=None, rtol=RTOL, atol=ATOL):
    kw = kw or {}
    want = np.asarray(getattr(rnn.functional.loss, name)(
        *[_to_ref(a) for a in args],
        **{k: _to_ref(v) for k, v in kw.items()}))
    got = getattr(pnn.functional.loss, name)(
        *[_to_port(a) for a in args],
        **{k: _to_port(v) for k, v in kw.items()})
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol,
                               atol=atol)


LBL = RS.randint(0, 5, (6,)).astype(np.int64)
LBL[2] = -100
PM1 = np.where(RS.rand(6) > 0.5, 1.0, -1.0).astype(np.float32)
CASES = {
    "nll_loss": lambda: ((_logp(6, 5), LBL), {}),
    "nll_loss_weighted": lambda: ((_logp(6, 5), LBL),
                                  {"weight": _p(5)}),
    "nll_loss_4d": lambda: ((_logp(2, 5, 3, 4),
                             RS.randint(0, 5, (2, 3, 4))), {}),
    "mse_loss": lambda: ((_f(4, 3), _f(4, 3)), {}),
    "l1_loss": lambda: ((_f(4, 3), _f(4, 3)), {}),
    "smooth_l1_loss": lambda: ((_f(4, 3), _f(4, 3)), {"delta": 0.7}),
    "binary_cross_entropy": lambda: ((_p(4, 3), _p(4, 3)),
                                     {"weight": _p(4, 3)}),
    "binary_cross_entropy_with_logits": lambda: (
        (_f(4, 3), _p(4, 3)), {"pos_weight": _p(3) * 3}),
    "kl_div": lambda: ((_logp(4, 3), _p(4, 3)), {}),
    "margin_ranking_loss": lambda: ((_f(6), _f(6), PM1), {"margin": 0.2}),
    "hinge_embedding_loss": lambda: ((_f(6), PM1), {"margin": 0.5}),
    "cosine_embedding_loss": lambda: ((_f(6, 4), _f(6, 4), PM1),
                                      {"margin": 0.1}),
    "triplet_margin_loss": lambda: ((_f(5, 4), _f(5, 4), _f(5, 4)),
                                    {"swap": True, "p": 3.0}),
    "sigmoid_focal_loss": lambda: ((_f(4, 3),
                                    (RS.rand(4, 3) > 0.5).astype(
                                        np.float32)), {"normalizer": 3.0}),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_loss_matches_the_reference(case, reduction):
    args, kw = CASES[case]()
    name = case.replace("_weighted", "").replace("_4d", "")
    _check(name, args, dict(kw, reduction=reduction))


@pytest.mark.parametrize("name,args", [
    ("log_loss", lambda: (_p(4, 1), (RS.rand(4, 1) > 0.5).astype(
        np.float32))),
    ("square_error_cost", lambda: (_f(4, 3), _f(4, 3))),
    ("npair_loss", lambda: (_f(6, 4), _f(6, 4),
                            RS.randint(0, 3, (6,)).astype(np.float32))),
    ("dice_loss", lambda: (np.asarray(jax.nn.softmax(_f(2, 3, 3, 4))),
                           RS.randint(0, 4, (2, 3, 3, 1)))),
    ("mae_loss", lambda: (_f(4, 3), _f(4, 3)))])
def test_unreduced_losses_match_the_reference(name, args):
    _check(name, args())


def test_kl_div_batchmean():
    _check("kl_div", (_logp(4, 3), _p(4, 3)), {"reduction": "batchmean"})


def _ctc_case():
    t, b, c, lab = 12, 3, 6, 4
    labels = RS.randint(1, c, (b, lab))
    labels[0, 1] = labels[0, 0]            # a repeat needs a blank between
    in_len = np.array([12, 9, 7])
    lab_len = np.array([4, 3, 2])
    return _logp(t, b, c), labels, in_len, lab_len


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("norm_by_times", [False, True])
def test_ctc_loss_matches_the_reference(reduction, norm_by_times):
    lp, labels, il, ll = _ctc_case()
    _check("ctc_loss", (lp, labels, il, ll),
           {"blank": 0, "reduction": reduction,
            "norm_by_times": norm_by_times}, rtol=2e-5)


def test_ctc_loss_gradient_and_layer():
    lp, labels, il, ll = _ctc_case()
    want = np.asarray(jax.grad(lambda x: rnn.functional.ctc_loss(
        x, jnp.asarray(labels), jnp.asarray(il), jnp.asarray(ll)))(
        jnp.asarray(lp)))
    x = torch.from_numpy(lp).requires_grad_()
    loss = pnn.CTCLoss(blank=0)(x, torch.from_numpy(labels),
                                torch.from_numpy(il), torch.from_numpy(ll))
    loss.backward()
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("custom", [False, True])
def test_hsigmoid_loss_and_layer(custom):
    n, d, classes = 6, 5, 7
    x = _f(n, d)
    label = RS.randint(0, classes, (n,))
    kw = {}
    rows = classes - 1
    if custom:
        rows = classes
        table = RS.randint(0, classes, (classes, 3))
        table[::2, 2] = -1
        kw = dict(path_table=table, path_code=RS.randint(0, 2, (classes, 3)))
    w, b = _f(rows, d), _f(rows)
    _check("hsigmoid_loss", (x, label, classes, w, b), kw)
    ref_kw = {k: jnp.asarray(v) for k, v in kw.items()}
    want, gx = jax.value_and_grad(lambda xx: jnp.sum(
        rnn.functional.hsigmoid_loss(xx, jnp.asarray(label), classes,
                                     jnp.asarray(w), jnp.asarray(b),
                                     **ref_kw)))(jnp.asarray(x))
    layer = pnn.HSigmoidLoss(d, classes, is_custom=custom)
    layer.set_state_dict({"weight": w, "bias": b.reshape(-1, 1)})
    xt = torch.from_numpy(x).requires_grad_()
    got = layer(xt, torch.from_numpy(label),
                **{k: torch.from_numpy(v) for k, v in kw.items()}).sum()
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-4,
                               atol=ATOL)


@pytest.mark.parametrize("layer,args,kw", [
    ("CrossEntropyLoss", lambda: (_f(6, 5), LBL), {"reduction": "sum"}),
    ("MSELoss", lambda: (_f(4, 3), _f(4, 3)), {}),
    ("L1Loss", lambda: (_f(4, 3), _f(4, 3)), {"reduction": "none"}),
    ("NLLLoss", lambda: (_logp(6, 5), LBL), {}),
    ("BCELoss", lambda: (_p(4, 3), _p(4, 3)), {}),
    ("BCEWithLogitsLoss", lambda: (_f(4, 3), _p(4, 3)), {}),
    ("KLDivLoss", lambda: (_logp(4, 3), _p(4, 3)), {}),
    ("SmoothL1Loss", lambda: (_f(4, 3), _f(4, 3)), {"delta": 2.0}),
    ("MarginRankingLoss", lambda: (_f(6), _f(6), PM1), {"margin": 0.3}),
    ("HingeEmbeddingLoss", lambda: (_f(6), PM1), {}),
    ("CosineEmbeddingLoss", lambda: (_f(6, 4), _f(6, 4), PM1), {}),
    ("TripletMarginLoss", lambda: (_f(5, 4), _f(5, 4), _f(5, 4)), {})])
def test_loss_layers_match_the_reference(layer, args, kw):
    a = args()
    want = np.asarray(getattr(rnn, layer)(**kw)(*[_to_ref(x) for x in a]))
    got = getattr(pnn, layer)(**kw)(*[_to_port(x) for x in a])
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
