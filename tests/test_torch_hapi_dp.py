"""``hapi.Model`` under data parallelism: one gloo world of 2 on the CPU
(``tests/torch_hapi_worker.py``), the reference's
``test_fit_data_parallel_matches_single_device`` setting
(``tests/test_hapi_e2e.py``: the MLP ``Linear(16,32)-ReLU-Linear(32,4)``,
SGD(0.1), 64 rows, 5 steps).

Each rank feeds the whole global batch to ``train_batch`` and takes its
32 rows; the gradients are averaged over the data group. The per-step
losses of both ranks equal each other and, within the reference's own
2e-4, the port's single-process run and the reference's single-device
run; the accuracy, the evaluation and the final weights agree the same
way, the loss falls.
"""
import pickle

import numpy as np
import pytest

import paddle_tpu as ref
from paddle_tpu.distributed.mesh import build_mesh as ref_build_mesh

import paddle_tpu_torch as port
import torch_hapi_worker as worker
from paddle_tpu_torch.distributed.spawn import spawn
from torch_threads import two_threads  # noqa: F401

pytestmark = pytest.mark.multihost(timeout=300)

RTOL = 2e-4      # the reference's bar for data>1 against one device
STEPS, LR, WORLD = 5, 0.1, 2


def _plan():
    rs = np.random.RandomState(0)
    x = rs.randn(64, 16).astype("float32")
    y = (x.sum(1) > 0).astype("int64") * 3
    names = worker.mlp(port.nn).named_state()
    weights = {k: (rs.randn(*v.shape) * 0.3).astype(np.float32)
               for k, v in names.items()}
    return {"weights": weights, "x": x, "y": y, "steps": STEPS, "lr": LR}


def _reference(plan):
    ref_build_mesh({"data": 1})
    net = worker.mlp(ref.nn)
    net.set_state_dict(plan["weights"])
    model = ref.Model(net)
    model.prepare(ref.optimizer.SGD(LR, parameters=net.parameters()),
                  ref.nn.CrossEntropyLoss(), ref.metric.Accuracy())
    return [model.train_batch([plan["x"]], [plan["y"]])[0]
            for _ in range(STEPS)]


def test_train_batch_under_data_2_matches_one_process(tmp_path):
    plan = _plan()
    with open(tmp_path / "plan.pkl", "wb") as f:
        pickle.dump(plan, f)
    spawn(worker.main, args=(str(tmp_path / "plan.pkl"), str(tmp_path)),
          nprocs=WORLD, timeout=240)
    ranks = []
    for r in range(WORLD):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    single = worker.run_steps(port, plan["weights"], plan["x"], plan["y"],
                              STEPS, LR)
    want_ref = _reference(plan)
    losses, accs, accumulated, ev, final = single
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses, want_ref, rtol=RTOL)
    for out in ranks:
        assert out["n"] == WORLD
        np.testing.assert_allclose(out["losses"], losses, rtol=RTOL)
        np.testing.assert_allclose(out["losses"], want_ref, rtol=RTOL)
        assert out["accs"] == accs and out["accumulated"] == accumulated
        np.testing.assert_allclose(out["eval"], ev, rtol=RTOL)
        for k, v in final.items():
            np.testing.assert_allclose(out["final"][k], v, rtol=RTOL,
                                       atol=1e-6)
    assert ranks[0]["losses"] == ranks[1]["losses"]
