"""The port's LocalSGD (``distributed/meta_parallel/localsgd.py``) against
the JAX package's ``LocalSGDTrainer`` on a CPU mesh of as many devices,
on gloo worlds of 2 and 4 (``torch_ep_worker.py``; every case of a world
in one spawn), from the same numpy weights and batch.

The cases are the reference's own (``tests/test_localsgd_elastic.py:
35-90``) and the quantized parameter sync:

- ``k1``: one local step between syncs (SGD 0.1, 5 steps); also equal to
  the port's data-parallel ``ParallelTrainer`` on the same model (for SGD
  ``mean(p - lr·g_i) == p - lr·mean(g_i)``);
- ``k4``: four local steps (SGD 0.05, 8 steps): the replicas differ after
  every step but the fourth and eighth, where they are equal bit for bit;
- ``adaptive``: k from 8 by the reference's rule on the MLP (SGD 0.2, 30
  steps): the same k after every step, and it shrinks;
- ``adam``: Adam's moments averaged with the parameters (k 2, 6 steps);
- ``int8``/``int4``: ``param_sync`` over the deltas from the anchor with a
  residual a rank (block 8, k 4).

Per step: the mean loss (rtol 1e-6) and every replica's weight. Bars are
the ZeRO tests': 2e-6 absolute for fp32, 5e-4 for the quantized syncs (a
block scale's rounding of a delta lands on either side of a quantization
step in the two packages' float32 sums).
"""
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import nn as rnn
from paddle_tpu.distributed.mesh import build_mesh as ref_build_mesh
from paddle_tpu.distributed.meta_parallel.localsgd import \
    LocalSGDTrainer as RefLocalSGD

import torch_ep_worker as worker

pytestmark = pytest.mark.multihost(timeout=300)

FP32_ATOL, QUANT_ATOL = 2e-6, 5e-4
_REF = {}


def _mse(o, y):
    return jnp.mean((o - y) ** 2)


def _ref_run(name, n):
    """Losses, every replica's weight after each step and k, of the
    reference's trainer on the case."""
    if (name, n) in _REF:
        return _REF[name, n]
    case = worker.LOCALSGD_CASES[name]
    x, y = worker.localsgd_data()
    ref_build_mesh({"data": n})
    paddle.seed(0)
    hidden = case.get("hidden", False)
    model = (rnn.Sequential(rnn.Linear(8, 16), rnn.Tanh(), rnn.Linear(16, 4))
             if hidden else rnn.Linear(8, 4))
    model.set_state_dict({k: jnp.asarray(v) for k, v in
                          worker.localsgd_weights(case["seed"],
                                                  hidden).items()})
    opt = (paddle.optimizer.Adam(case["lr"], parameters=model.parameters())
           if case["opt"] == "adam" else
           paddle.optimizer.SGD(case["lr"], parameters=model.parameters()))
    kw = {k: case[k] for k in ("k_steps", "adaptive", "init_k_steps",
                               "max_k_steps", "param_sync",
                               "param_sync_block") if k in case}
    tr = RefLocalSGD(model, opt, _mse, **kw)
    wkey = "0.weight" if hidden else "weight"
    losses, reps, ks = [], [], []
    for _ in range(case["steps"]):
        losses.append(float(tr.train_step(x, y)))
        reps.append(np.array(tr.replica_params(wkey), copy=True))
        ks.append(tr.k_steps)
    _REF[name, n] = (losses, reps, ks)
    return _REF[name, n]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", list(worker.LOCALSGD_CASES))
def test_localsgd_matches_the_reference(name, n, tmp_path_factory):
    ranks = worker.world(n, tmp_path_factory, kinds=("localsgd",))
    losses, reps, ks = _ref_run(name, n)
    atol = QUANT_ATOL if "param_sync" in worker.LOCALSGD_CASES[name] \
        else FP32_ATOL
    for r, got in enumerate(ranks):
        g = got["localsgd"][name]
        np.testing.assert_allclose(g["losses"], losses, rtol=1e-6,
                                   atol=atol)
        assert g["k"] == ks
        for step, (a, b) in enumerate(zip(g["replicas"], reps)):
            np.testing.assert_allclose(a, b, rtol=0, atol=atol,
                                       err_msg=f"{name} step {step}")


@pytest.mark.parametrize("n", [2, 4])
def test_k1_is_data_parallelism(n, tmp_path_factory):
    ranks = worker.world(n, tmp_path_factory, kinds=("localsgd",))
    for got in ranks:
        ls = got["localsgd"]
        np.testing.assert_allclose(ls["k1"]["losses"], ls["dp"]["losses"],
                                   rtol=1e-5)
        np.testing.assert_allclose(ls["k1"]["replicas"][-1][got["rank"]],
                                   ls["dp"]["weight"], rtol=0,
                                   atol=FP32_ATOL)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", ["k4", "int8", "int4"])
def test_replicas_diverge_then_sync(name, n, tmp_path_factory):
    ranks = worker.world(n, tmp_path_factory, kinds=("localsgd",))
    g = ranks[0]["localsgd"][name]
    for step, reps in enumerate(g["replicas"], start=1):
        spread = np.abs(reps - reps.mean(0, keepdims=True)).max()
        if step % 4 == 0:
            assert spread == 0.0, (step, spread)     # just synced
        else:
            assert spread > 1e-7, (step, spread)     # local divergence
    assert g["losses"][-1] < g["losses"][0]
    # the averaged state is the replicas' mean, on every rank alike
    np.testing.assert_allclose(g["averaged"]["weight"],
                               g["replicas"][-1].mean(0), rtol=0, atol=1e-6)
    if name != "k4":
        assert 0 < g["wire_bytes"] < ranks[0]["localsgd"]["k4"]["wire_bytes"]


@pytest.mark.parametrize("n", [2, 4])
def test_adaptive_k_shrinks_and_adam_trains(n, tmp_path_factory):
    ranks = worker.world(n, tmp_path_factory, kinds=("localsgd",))
    ls = ranks[0]["localsgd"]
    assert 1 <= ls["adaptive"]["k"][-1] < 8
    adam = ls["adam"]["losses"]
    assert np.isfinite(adam).all() and adam[-1] < adam[0]


def test_program_analysis_hooks_name_their_item():
    import torch
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.distributed.meta_parallel import LocalSGDTrainer
    tr = LocalSGDTrainer(nn.Linear(8, 4), optimizer.SGD(0.1),
                         lambda o, y: ((o - y) ** 2).mean(),
                         mesh=mesh_mod.build_mesh({"data": 1}), device="cpu")
    x = torch.zeros(4, 8)
    for call in (lambda: tr.step_jaxpr(True, x, x),
                 lambda: tr.program_family(x, x)):
        with pytest.raises(NotImplementedError, match="item 16"):
            call()
