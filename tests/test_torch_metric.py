"""The port's ``metric`` against the JAX package's, on the CPU, on seeded
inputs: ``Accuracy`` (top-1 and top-k, one-hot labels, ties) through
``compute``, ``update`` and ``accumulate``; ``Precision`` and ``Recall``
(counts exact); ``Auc`` (its bins exact, its value within 1e-7; both
prediction layouts); the functional ``accuracy``. ``compute`` runs in
torch, ``update`` takes tensors or arrays.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu import metric as rmetric

from paddle_tpu_torch import metric as pmetric
from torch_threads import two_threads  # noqa: F401

AUC_TOL = 1e-7


def _rs(seed):
    return np.random.RandomState(seed)


@pytest.mark.parametrize("topk", [(1,), (1, 5), 3])
@pytest.mark.parametrize("onehot", [False, True])
def test_accuracy_matches_the_reference(topk, onehot):
    rm, pm = rmetric.Accuracy(topk=topk), pmetric.Accuracy(topk=topk)
    assert rm.name() == pm.name()
    rs = _rs(0)
    for step in range(3):
        # quantized scores: ties, which both must rank alike
        pred = np.round(rs.randn(16, 10), 1).astype(np.float32)
        label = rs.randint(0, 10, 16).astype(np.int64)
        lbl = np.eye(10, dtype=np.float32)[label] if onehot else label
        rc = np.asarray(rm.compute(jnp.asarray(pred), jnp.asarray(lbl)))
        pc = pm.compute(torch.from_numpy(pred), torch.from_numpy(lbl))
        assert pc.dtype == torch.float32
        np.testing.assert_array_equal(pc.numpy(), rc)
        assert rm.update(rc) == pm.update(pc)
    assert rm.accumulate() == pm.accumulate()
    assert rm.total == pm.total and rm.count == pm.count
    pm.reset()
    assert pm.accumulate() == (0.0 if len(pm.topk) == 1
                               else [0.0] * len(pm.topk))


@pytest.mark.parametrize("cls", ["Precision", "Recall"])
def test_precision_recall_counts_exact(cls):
    rm, pm = getattr(rmetric, cls)(), getattr(pmetric, cls)()
    rs = _rs(1)
    for _ in range(4):
        preds = rs.rand(37).astype(np.float32)
        labels = rs.randint(0, 2, 37)
        rm.update(preds, labels)
        pm.update(torch.from_numpy(preds), labels)
    counts = ("tp", "fp") if cls == "Precision" else ("tp", "fn")
    assert [getattr(rm, c) for c in counts] == \
        [getattr(pm, c) for c in counts]
    assert rm.accumulate() == pm.accumulate()
    assert rm.name() == pm.name()


@pytest.mark.parametrize("two_columns", [False, True])
def test_auc_matches_the_reference(two_columns):
    rm, pm = rmetric.Auc(), pmetric.Auc(num_thresholds=4095)
    rs = _rs(2)
    for _ in range(3):
        pos = rs.rand(200).astype(np.float32)
        labels = (rs.rand(200) < pos).astype(np.int64)
        preds = np.stack([1 - pos, pos], 1) if two_columns else pos[:, None]
        rm.update(preds, labels)
        pm.update(torch.from_numpy(preds), torch.from_numpy(labels))
    np.testing.assert_array_equal(rm._stat_pos, pm._stat_pos)
    np.testing.assert_array_equal(rm._stat_neg, pm._stat_neg)
    assert abs(rm.accumulate() - pm.accumulate()) <= AUC_TOL
    assert 0.5 < pm.accumulate() < 1.0


@pytest.mark.parametrize("k", [1, 3])
def test_functional_accuracy(k):
    rs = _rs(3)
    x = np.round(rs.randn(32, 8), 1).astype(np.float32)
    y = rs.randint(0, 8, 32).astype(np.int64)
    want = float(rmetric.accuracy(jnp.asarray(x), jnp.asarray(y), k=k))
    got = pmetric.accuracy(torch.from_numpy(x), torch.from_numpy(y), k=k)
    assert got.dim() == 0 and got.dtype == torch.float32
    assert float(got) == want
