"""Metrics (port of ``paddle_tpu/metric``; reference
python/paddle/metric/metrics.py).

``compute`` runs in torch on the outputs' device, inside the step, where
the reference's runs inside the jitted step; ``update`` and ``accumulate``
run on the host in numpy, as the reference's do (``update`` takes tensors
or arrays). Ties rank as in the reference: ``Accuracy`` reverses an
ascending stable sort (the later index first), ``accuracy`` is
``lax.top_k``'s order (the earlier index first).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


class Metric:
    def __init__(self):
        pass

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        """Optional pre-processing on the outputs' device, inside the
        step; its results go to :meth:`update`."""
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None, *args, **kwargs):
        super().__init__()
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label, *args):
        """(N, maxk) float32: 1 where the k-th ranked class is the
        label."""
        pred = torch.argsort(pred, dim=-1, stable=True).flip(-1)
        pred = pred[..., :self.maxk]
        if label.dim() == 1:
            label = label.reshape(-1, 1)
        elif label.shape[-1] != 1:
            label = torch.argmax(label, dim=-1, keepdim=True)
        return (pred == label).to(torch.float32)

    def update(self, correct, *args):
        correct = _numpy(correct)
        accs = []
        for k in self.topk:
            num_corrects = correct[..., :k].sum()
            num_samples = int(np.prod(correct.shape[:-1]))
            accs.append(float(num_corrects) / num_samples
                        if num_samples else 0.0)
            self.total[self.topk.index(k)] += float(num_corrects)
            self.count[self.topk.index(k)] += num_samples
        return accs[0] if len(self.topk) == 1 else accs

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / c if c > 0 else 0.0
               for t, c in zip(self.total, self.count)]
        return res[0] if len(self.topk) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name="precision", *args, **kwargs):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = np.rint(_numpy(preds)).astype(np.int32).reshape(-1)
        labels = _numpy(labels).astype(np.int32).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fp += int(np.sum((preds == 1) & (labels == 0)))

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall", *args, **kwargs):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = np.rint(_numpy(preds)).astype(np.int32).reshape(-1)
        labels = _numpy(labels).astype(np.int32).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fn += int(np.sum((preds == 0) & (labels == 1)))

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """ROC AUC over ``num_thresholds`` bins of the positive probability
    (the second column of a two-column prediction, else the prediction
    itself)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc", *args,
                 **kwargs):
        super().__init__()
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def update(self, preds, labels):
        preds = _numpy(preds)
        labels = _numpy(labels).reshape(-1)
        pos_prob = preds[:, 1] if preds.ndim == 2 and preds.shape[1] == 2 \
            else preds.reshape(-1)
        bins = np.minimum((pos_prob * self.num_thresholds).astype(np.int64),
                          self.num_thresholds - 1)
        pos = labels.astype(bool)
        self._stat_pos += np.bincount(bins[pos],
                                      minlength=self.num_thresholds)
        self._stat_neg += np.bincount(bins[~pos],
                                      minlength=self.num_thresholds)

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds, dtype=np.int64)
        self._stat_neg = np.zeros(self.num_thresholds, dtype=np.int64)

    def accumulate(self):
        tot_pos = 0.0
        tot_neg = 0.0
        auc = 0.0
        for i in range(self.num_thresholds - 1, -1, -1):
            new_pos = tot_pos + self._stat_pos[i]
            new_neg = tot_neg + self._stat_neg[i]
            auc += (new_pos + tot_pos) * (new_neg - tot_neg) / 2.0
            tot_pos, tot_neg = new_pos, new_neg
        denom = tot_pos * tot_neg
        return auc / denom if denom else 0.0

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """Top-``k`` accuracy of one batch as a 0-d float32 tensor on the
    input's device (reference: fluid/layers/metric_op.py)."""
    idx = torch.argsort(input, dim=-1, descending=True, stable=True)[..., :k]
    if label.dim() == 1:
        label = label[:, None]
    hit = (idx == label).any(dim=-1)
    return hit.to(torch.float32).mean()
