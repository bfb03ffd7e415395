"""The port's ``incubate`` (``asp``, ``operators``, ``optimizer``) and
``distribution`` against the JAX package's, on the CPU.

- ASP, the cases of ``tests/test_dgc_asp.py``'s ASP half on both
  packages: the masks bit for bit the reference's (random weights, and
  weights full of ties, in float32 and bfloat16), pruned weights equal,
  sparsity kept through training in ``ParallelTrainer`` (decorate before
  or after ``prune_model``, ``prune_params`` mid-training) and through
  the eager ``step()``, a custom group size.
- ``LookAhead`` and ``ModelAverage``: ``tests/test_api_tail.py``'s cases,
  and ``apply_gradients`` over k+1 steps against the reference's at
  :data:`OPT_TOL`; the golden runs of ``incubate_golden.json`` (written by
  ``tests/torch_incubate_golden.py``) through ``chip_smoke``'s own code
  on the CPU at :data:`GOLDEN_LOSS_RTOL`/:data:`GOLDEN_NORM_RTOL`.
- ``softmax_mask_fuse_upper_triangle`` against the reference's.
- ``Normal``, ``Uniform`` and ``Categorical``: ``log_prob``, ``probs``,
  ``entropy`` and ``kl_divergence`` against the reference's at
  :data:`DIST_TOL`; samples repeat under a nonzero ``seed`` and follow
  the global seed otherwise, and their moments hold.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as ref
from paddle_tpu import distribution as rdist
from paddle_tpu import nn as rnn
from paddle_tpu.distributed.engine import ParallelTrainer as RTrainer
from paddle_tpu.distributed.mesh import build_mesh
from paddle_tpu.incubate import asp as rasp
from paddle_tpu.incubate import optimizer as ropt_inc

import paddle_tpu_torch as port
from paddle_tpu_torch import distribution as pdist
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import optimizer as poptim
from paddle_tpu_torch.distributed.engine import ParallelTrainer as PTrainer
from paddle_tpu_torch.incubate import asp as pasp
from paddle_tpu_torch.incubate import operators as pops
from paddle_tpu_torch.incubate import optimizer as popt_inc

import chip_smoke
from torch_threads import two_threads  # noqa: F401

OPT_TOL = 1e-6          # LookAhead/ModelAverage against the reference
DIST_TOL = 1e-6         # log_prob, entropy, kl_divergence
GOLDEN_LOSS_RTOL = 1e-6  # the port's CPU golden runs against the file
GOLDEN_NORM_RTOL = 1e-5


def _mse_ref(o, y):
    return jnp.mean((o - y) ** 2)


def _mse_port(o, y):
    return torch.mean((o - y) ** 2)


def _carry(rm, pm, seed=0):
    rs = np.random.RandomState(seed)
    w = {k: rs.randn(*v.shape).astype(np.float32) * 0.5
         for k, v in rm.state_dict().items()}
    rm.set_state_dict({k: jnp.asarray(v) for k, v in w.items()})
    pm.set_state_dict_from_numpy(w)
    return w


def _data(rows=16, out=4, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(rows, 8).astype("f4"), rs.randn(rows, out).astype("f4"))


# -- ASP -----------------------------------------------------------------------

def _tied(rs):
    """Weights full of ties: small integers, so groups hold equal
    magnitudes of either sign."""
    return rs.randint(-2, 3, (16, 32)).astype(np.float32)


@pytest.mark.parametrize("kind", ["randn", "ties", "ties_bf16", "m2"])
def test_masks_bit_for_bit(kind):
    rs = np.random.RandomState(0)
    w = _tied(rs) if kind.startswith("ties") else \
        rs.randn(8, 16).astype("f4")
    n, m = (1, 2) if kind == "m2" else (2, 4)
    rw = jnp.asarray(w, jnp.bfloat16) if kind.endswith("bf16") else w
    pw = torch.from_numpy(w).to(torch.bfloat16) if kind.endswith("bf16") \
        else torch.from_numpy(w)
    want = np.asarray(rasp.compute_nm_mask(rw, n, m))
    got = pasp.compute_nm_mask(pw, n, m).numpy()
    np.testing.assert_array_equal(got, want)
    groups = got.reshape(-1, m)
    assert (groups.sum(axis=-1) == n).all()
    assert pasp.check_sparsity(pw * torch.from_numpy(got).to(pw.dtype),
                               n, m)
    assert not pasp.check_sparsity(pw + 10.0, n, m)


def test_prune_model_matches_the_reference():
    rnet, pnet = rnn.Linear(8, 16), pnn.Linear(8, 16)
    _carry(rnet, pnet)
    rmasks = rasp.prune_model(rnet)
    pmasks = pasp.prune_model(pnet)
    assert set(pmasks) == set(rmasks) == {"weight"}
    np.testing.assert_array_equal(pmasks["weight"].numpy(),
                                  np.asarray(rmasks["weight"]))
    np.testing.assert_array_equal(pnet.weight.detach().numpy(),
                                  np.asarray(rnet.weight.value))
    assert pasp.check_sparsity(pnet.weight)
    pasp.reset(pnet)


def _mlp(n):
    return n.Sequential(n.Linear(8, 16), n.Tanh(), n.Linear(16, 4))


@pytest.mark.parametrize("order", ["prune_then_decorate",
                                   "decorate_then_prune"])
def test_sparsity_kept_through_training(order):
    build_mesh({"data": 1})
    rnet, pnet = _mlp(rnn), _mlp(pnn)
    _carry(rnet, pnet, 1)
    ropt = ref.optimizer.Momentum(0.05, parameters=rnet.parameters())
    popt = poptim.Momentum(0.05)
    if order == "prune_then_decorate":
        rasp.prune_model(rnet)
        pasp.prune_model(pnet)
    ropt = rasp.decorate(ropt, rnet)
    popt = pasp.decorate(popt, pnet)
    if order == "decorate_then_prune":
        rasp.prune_model(rnet)
        pasp.prune_model(pnet)
    rtr = RTrainer(rnet, ropt, _mse_ref)
    ptr = PTrainer(pnet, popt, _mse_port, device="cpu")
    x, y = _data()
    rl = [float(rtr.train_step(x, y)) for _ in range(6)]
    pl = [float(ptr.train_step(x, y)) for _ in range(6)]
    assert pl[-1] < pl[0]
    np.testing.assert_allclose(pl, rl, rtol=1e-5)
    for k in ("0.weight", "2.weight"):
        w = ptr.params[k].detach()
        assert pasp.check_sparsity(w)
        np.testing.assert_array_equal(
            (w.numpy() == 0), np.asarray(rtr.state["params"][k]) == 0)


def test_prune_params_mid_training():
    build_mesh({"data": 1})
    pnet = pnn.Linear(8, 16)
    rs = np.random.RandomState(1)
    pnet.set_state_dict_from_numpy(
        {"weight": rs.randn(8, 16).astype("f4"),
         "bias": np.zeros(16, "f4")})
    opt = pasp.decorate(poptim.SGD(0.1), pnet)
    tr = PTrainer(pnet, opt, _mse_port, device="cpu")
    x = rs.randn(8, 8).astype("f4")
    y = rs.randn(8, 16).astype("f4")
    for _ in range(2):
        tr.train_step(x, y)
    assert not pasp.check_sparsity(tr.params["weight"])
    new, masks = pasp.prune_params(
        {k: v.detach() for k, v in tr.params.items()})
    rnew, rmasks = rasp.prune_params(
        {k: jnp.asarray(v.detach().numpy()) for k, v in tr.params.items()})
    np.testing.assert_array_equal(masks["weight"].numpy(),
                                  np.asarray(rmasks["weight"]))
    with torch.no_grad():
        tr.params["weight"].copy_(new["weight"])
    for _ in range(3):
        tr.train_step(x, y)
    w = tr.params["weight"].detach()
    assert pasp.check_sparsity(w) and float(w.abs().sum()) > 0


def test_eager_step_keeps_the_mask():
    pnet = pnn.Linear(8, 16)
    pasp.prune_model(pnet)
    opt = pasp.decorate(poptim.SGD(0.1, parameters=pnet.parameters()), pnet)
    zero = pnet.weight.detach() == 0
    x, y = (torch.from_numpy(a) for a in _data(8, 16, 2))
    for _ in range(3):
        loss = _mse_port(pnet(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
    assert pasp.check_sparsity(pnet.weight)
    assert not bool(pnet.weight.detach()[zero].any())


def test_custom_group_size():
    pnet = pnn.Linear(8, 6)
    masks = pasp.prune_model(pnet, n=1, m=2)
    assert "weight" in masks
    assert pasp.check_sparsity(pnet.weight, n=1, m=2)
    assert not pasp.check_sparsity(pnet.weight)     # 6 % 4 != 0


# -- LookAhead and ModelAverage -------------------------------------------------

def _arrays(seed, shapes=(("w", (6, 5)), ("b", (5,)))):
    rs = np.random.RandomState(seed)
    return {k: rs.randn(*s).astype(np.float32) for k, s in shapes}


def test_lookahead_matches_the_reference_over_k_plus_1_steps():
    k = 3
    ropt = ropt_inc.LookAhead(ref.optimizer.AdamW(0.01, weight_decay=0.1),
                              alpha=0.4, k=k)
    popt = popt_inc.LookAhead(poptim.AdamW(0.01, weight_decay=0.1),
                              alpha=0.4, k=k)
    p0 = _arrays(0)
    rp = {n: jnp.asarray(v) for n, v in p0.items()}
    pp = {n: torch.from_numpy(v) for n, v in p0.items()}
    rs_, ps_ = ropt.init_state(rp), popt.init_state(pp)
    for i in range(k + 1):
        g = _arrays(10 + i)
        rp, rs_ = ropt.apply_gradients(rp, {n: jnp.asarray(v)
                                            for n, v in g.items()}, rs_)
        pp, ps_ = popt.apply_gradients(pp, {n: torch.from_numpy(v)
                                            for n, v in g.items()}, ps_)
        for n in p0:
            np.testing.assert_allclose(pp[n].numpy(), np.asarray(rp[n]),
                                       rtol=OPT_TOL, atol=OPT_TOL)
            np.testing.assert_allclose(ps_["slow"][n].numpy(),
                                       np.asarray(rs_["slow"][n]),
                                       rtol=OPT_TOL, atol=OPT_TOL)
    assert int(ps_["la_step"]) == k + 1


def test_lookahead_slow_weights_sync_every_k():
    opt = popt_inc.LookAhead(poptim.SGD(1.0), alpha=0.5, k=3)
    params = {"w": torch.tensor([4.0])}
    state = opt.init_state(params)
    g = {"w": torch.tensor([1.0])}
    for expect in (3.0, 2.0):
        params, state = opt.apply_gradients(params, dict(g), state, lr=1.0)
        assert float(params["w"][0]) == pytest.approx(expect)
    params, state = opt.apply_gradients(params, dict(g), state, lr=1.0)
    assert float(params["w"][0]) == pytest.approx(2.5)
    assert float(state["slow"]["w"][0]) == pytest.approx(2.5)
    with pytest.raises(ValueError):
        popt_inc.LookAhead(poptim.SGD(0.1), alpha=1.5)
    with pytest.raises(ValueError):
        popt_inc.LookAhead(poptim.SGD(0.1), k=0)


def test_lookahead_trains_in_parallel_trainer():
    port.seed(1)
    net = _mlp(pnn)
    opt = popt_inc.LookAhead(poptim.SGD(0.1), alpha=0.8, k=5)
    tr = PTrainer(net, opt, _mse_port, device="cpu")
    x, y = _data(16, 4, 3)
    losses = [float(tr.train_step(x, y)) for _ in range(12)]
    assert losses[-1] < losses[0]


def test_model_average_matches_the_reference_over_k_plus_1_steps():
    kw = dict(min_average_window=2, max_average_window=3)
    rma = ropt_inc.ModelAverage(0.5, **kw)
    pma = popt_inc.ModelAverage(0.5, **kw)
    rs_ = ps_ = None
    for i in range(5):
        p = _arrays(20 + i)
        rp = {n: jnp.asarray(v) for n, v in p.items()}
        pp = {n: torch.from_numpy(v) for n, v in p.items()}
        rs_ = rs_ or rma.init_state(rp)
        ps_ = ps_ or pma.init_state(pp)
        _, rs_ = rma.apply_gradients(rp, None, rs_)
        _, ps_ = pma.apply_gradients(pp, None, ps_)
        for key in ("num_1", "num_2", "num_3", "num_updates"):
            assert int(ps_[key]) == int(rs_[key]), key
        ravg, pavg = rma._average(rs_), pma.average(ps_)
        for n in p:
            np.testing.assert_allclose(pavg[n].numpy(), np.asarray(ravg[n]),
                                       rtol=OPT_TOL, atol=OPT_TOL)


def test_model_average_apply_and_restore():
    lin = pnn.Linear(1, 1, bias_attr=False)
    ma = popt_inc.ModelAverage(0.5, parameters=lin.parameters(),
                               min_average_window=2, max_average_window=4)
    seen = []
    for v in (1.0, 2.0, 3.0, 4.0):
        with torch.no_grad():
            lin.weight.fill_(v)
        seen.append(v)
        ma.step()
    with ma.apply():
        assert float(lin.weight.detach()[0, 0]) == pytest.approx(np.mean(seen))
    assert float(lin.weight.detach()[0, 0]) == pytest.approx(4.0)
    lin2 = pnn.Linear(1, 1, bias_attr=False)
    ma2 = popt_inc.ModelAverage(1.0, parameters=lin2.parameters(),
                                min_average_window=100)
    with torch.no_grad():
        lin2.weight.fill_(10.0)
    ma2.step()
    with ma2.apply(need_restore=False):
        pass
    assert float(lin2.weight.detach()[0, 0]) == pytest.approx(10.0)
    ma2.restore()


def test_golden_runs_on_the_cpu():
    from paddle_tpu_torch import framework, incubate
    from paddle_tpu_torch.distributed import engine
    from paddle_tpu_torch.text.models import gpt
    got, gold = chip_smoke.incubate_golden_run(
        pnn, gpt, engine, poptim, framework, incubate, device="cpu")
    chip_smoke.hold_incubate_golden(got, gold, GOLDEN_LOSS_RTOL,
                                    GOLDEN_NORM_RTOL)
    assert gold["recipe"]["steps"] > gold["recipe"]["lookahead"]["k"]


# -- the masked softmax -----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_softmax_matches_the_reference(dtype):
    from paddle_tpu.incubate import softmax_mask_fuse_upper_triangle as rfn
    x = np.random.RandomState(0).randn(2, 3, 5, 7).astype("f4")
    got = pops.softmax_mask_fuse_upper_triangle(
        torch.from_numpy(x).to(getattr(torch, dtype)))
    want = np.asarray(rfn(jnp.asarray(x, dtype)).astype(jnp.float32))
    tol = 1e-6 if dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol)
    assert (got[..., 0, 1:] == 0).all() and got.dtype == getattr(torch,
                                                                 dtype)


# -- distributions ------------------------------------------------------------------

def _pairs():
    rs = np.random.RandomState(5)
    loc, scale = rs.randn(3).astype("f4"), rs.uniform(0.5, 2, 3).astype("f4")
    low = rs.randn(3).astype("f4")
    high = low + rs.uniform(0.5, 2, 3).astype("f4")
    logits = rs.randn(3, 5).astype("f4")
    return [
        ("normal", rdist.Normal(loc, scale), pdist.Normal(loc, scale),
         rdist.Normal(loc[::-1].copy(), scale * 1.5),
         pdist.Normal(loc[::-1].copy(), scale * 1.5),
         rs.randn(4, 3).astype("f4")),
        ("uniform", rdist.Uniform(low, high), pdist.Uniform(low, high),
         None, None, (low + (high - low) * rs.uniform(-0.5, 1.5, (4, 3)))
         .astype("f4")),
        ("categorical", rdist.Categorical(logits),
         pdist.Categorical(logits), rdist.Categorical(logits[::-1].copy()),
         pdist.Categorical(logits[::-1].copy()),
         rs.randint(0, 5, (3,))),
    ]


@pytest.mark.parametrize("case", _pairs(), ids=lambda c: c[0])
def test_distribution_formulas_match_the_reference(case):
    name, rd, pd_, rother, pother, value = case
    for fn in ("log_prob", "probs"):
        want = np.asarray(getattr(rd, fn)(jnp.asarray(value)))
        got = getattr(pd_, fn)(value).numpy()
        np.testing.assert_allclose(got, want, rtol=DIST_TOL, atol=DIST_TOL,
                                   err_msg=fn)
    np.testing.assert_allclose(pd_.entropy().numpy(),
                               np.asarray(rd.entropy()), rtol=DIST_TOL)
    if rother is not None:
        np.testing.assert_allclose(pd_.kl_divergence(pother).numpy(),
                                   np.asarray(rd.kl_divergence(rother)),
                                   rtol=DIST_TOL, atol=DIST_TOL)


def test_distribution_samples():
    n = 200_000
    normal = pdist.Normal(0.5, 2.0)
    a = normal.sample((n,), seed=3)
    assert torch.equal(a, normal.sample((n,), seed=3))
    assert not torch.equal(a, normal.sample((n,), seed=4))
    assert abs(float(a.mean()) - 0.5) < 5 * 2.0 / n ** 0.5
    assert abs(float(a.std()) - 2.0) < 5 * 2.0 / n ** 0.5
    port.seed(11)
    b = normal.sample((4,))
    port.seed(11)
    assert torch.equal(b, normal.sample((4,)))
    u = pdist.Uniform([0.0, 1.0], [1.0, 3.0]).sample((n,), seed=5)
    assert tuple(u.shape) == (n, 2)
    assert (u[:, 0] >= 0).all() and (u[:, 1] < 3).all()
    np.testing.assert_allclose(u.mean(0).numpy(), [0.5, 2.0], atol=0.01)
    logits = np.log(np.array([0.1, 0.2, 0.7], "f4"))
    c = pdist.Categorical(logits).sample((n,), seed=7)
    freq = np.bincount(c.numpy(), minlength=3) / n
    np.testing.assert_allclose(freq, [0.1, 0.2, 0.7], atol=0.01)
    assert tuple(pdist.Categorical(np.zeros((2, 3), "f4"))
                 .sample((4,), seed=1).shape) == (4, 2)
