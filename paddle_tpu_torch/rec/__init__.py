"""Sparse recommender models: Wide&Deep and DeepFM.

Port of ``paddle_tpu/rec/__init__.py`` (the reference serves the workload
through PaddleRec on the parameter-server tier: dist_fleet_ctr.py,
common_sparse_table.cc). Three storage modes, the same math:

- bounded vocabulary (default): ``nn.Embedding`` parameters on the card;
- ``sparse=True``: the id features on the host parameter server
  (``distributed.ps.DistributedEmbedding``: rows made on first touch, the
  table's Adagrad applied at push);
- ``sparse="heter"``: the hot tier on the card over the host table
  (``distributed.ps.HeterEmbedding``): one ``embedding_dim + 1`` wide table
  serves the wide weight (column 0) and the deep embedding (columns 1:),
  the reference CTR accessor's ``[w, embedx...]`` row. Call ``slots =
  model.prepare_batch(ids)`` on the host each step and feed ``slots`` in
  place of ``ids``.

Inputs: ``ids`` (B, F), one categorical id per field (-1 for a missing
one), and ``dense`` (B, D) continuous features; ``model((ids, dense))``
also works (the trainer's one inputs tuple). Output: the CTR logit (B,).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import nn

__all__ = ["WideDeep", "DeepFM"]


def _sparse_tables(field_dims, dim, sparse, lr):
    if not sparse:
        return nn.Embedding(sum(field_dims), dim)
    from ..distributed.ps import DistributedEmbedding
    return DistributedEmbedding(dim, "adagrad", lr=lr)


def _mlp(prev, hidden_sizes):
    layers = []
    for h in hidden_sizes:
        layers += [nn.Linear(prev, h), nn.ReLU()]
        prev = h
    layers.append(nn.Linear(prev, 1))
    return nn.Sequential(*layers)


class _RecBase(nn.Layer):
    def __init__(self, field_dims: Sequence[int], dense_dim: int,
                 embedding_dim: int, sparse, sparse_lr: float,
                 heter_capacity: int = 0,
                 heter_optimizer: str = "adagrad"):
        super().__init__()
        self.field_dims = list(field_dims)
        self.num_fields = len(self.field_dims)
        self.dense_dim = dense_dim
        self.embedding_dim = embedding_dim
        self.sparse = sparse
        # per-field vocabularies folded into one id space: one table serves
        # every field (the reference's slot-prefixed keys)
        self._np_offsets = np.concatenate(
            [[0], np.cumsum(self.field_dims)[:-1]]).astype(np.int64)
        self.register_buffer("field_offsets",
                             torch.from_numpy(self._np_offsets),
                             persistent=False)
        if sparse == "heter":
            from ..distributed.ps import HeterEmbedding
            cap = heter_capacity or max(2048, sum(self.field_dims) // 8)
            # the table's optimizer is the training optimizer, so the
            # accumulators move with the rows on evict and promote
            self.ctr_table = HeterEmbedding(embedding_dim + 1, capacity=cap,
                                            optimizer=heter_optimizer)
        else:
            self.embedding = _sparse_tables(self.field_dims, embedding_dim,
                                            sparse, sparse_lr)
            self.linear_emb = _sparse_tables(self.field_dims, 1, sparse,
                                             sparse_lr)

    def _fold_np(self, ids):
        ids = np.asarray(ids)
        return np.where(ids < 0, -1, ids + self._np_offsets[None, :])

    def prepare_batch(self, ids) -> np.ndarray:
        """Heter mode's host step: fold the raw ids and run the hot tier's
        promote and evict; returns the slot ids to feed the step."""
        assert self.sparse == "heter", "prepare_batch is heter-mode only"
        return self.ctr_table.prepare(self._fold_np(ids))

    def prepare_batch_async(self, ids):
        """:meth:`prepare_batch` on the hot tier's worker (a Future): batch
        k+1's host work overlaps step k on the card."""
        assert self.sparse == "heter", "prepare_batch is heter-mode only"
        return self.ctr_table.prepare_async(self._fold_np(ids))

    def attach_trainer(self, trainer):
        """Heter mode: bind the hot tier to a trainer (``ParallelTrainer``
        binds it at construction; no call is needed there)."""
        assert self.sparse == "heter", "attach_trainer is heter-mode only"
        self.ctr_table.attach(trainer)
        return self

    def _fold_ids(self, ids):
        ids = torch.as_tensor(ids, device=self.field_offsets.device).long()
        folded = ids + self.field_offsets[None, :]
        # a missing id (-1) stays negative: the PS path zeroes it, the
        # dense path clamps and masks
        return torch.where(ids < 0, -1, folded)

    def _lookup(self, table, folded):
        if self.sparse:
            return table(folded)
        mask = folded >= 0
        out = table(torch.where(mask, folded, 0))
        return out * mask[..., None].to(out.dtype)

    def _wide_and_emb(self, ids):
        """(wide per field (B, F), embeddings (B, F, E)) in every mode;
        heter mode takes prepared SLOT ids."""
        if self.sparse == "heter":
            rows = self.ctr_table(ids)                   # (B, F, E+1)
            return rows[..., 0], rows[..., 1:]
        folded = self._fold_ids(ids)
        wide = self._lookup(self.linear_emb, folded)[..., 0]
        return wide, self._lookup(self.embedding, folded)


class WideDeep(_RecBase):
    """wide (linear over the sparse ids and the dense features) + deep (an
    MLP over the embeddings ++ dense); logit = wide + deep."""

    def __init__(self, field_dims: Sequence[int], dense_dim: int = 13,
                 embedding_dim: int = 16,
                 hidden_sizes: Sequence[int] = (128, 64, 32),
                 sparse=False, sparse_lr: float = 0.05,
                 heter_capacity: int = 0,
                 heter_optimizer: str = "adagrad"):
        super().__init__(field_dims, dense_dim, embedding_dim, sparse,
                         sparse_lr, heter_capacity, heter_optimizer)
        self.wide_dense = nn.Linear(dense_dim, 1)
        self.deep = _mlp(self.num_fields * embedding_dim + dense_dim,
                         hidden_sizes)

    def forward(self, ids, dense=None):
        if dense is None:
            ids, dense = ids
        wide_f, emb = self._wide_and_emb(ids)              # (B,F), (B,F,E)
        dense = torch.as_tensor(dense, device=emb.device).to(emb.dtype)
        wide = wide_f.sum(dim=1) + self.wide_dense(dense)[:, 0]
        deep_in = torch.cat([emb.reshape(emb.shape[0], -1), dense], dim=-1)
        return wide + self.deep(deep_in)[:, 0]


class DeepFM(_RecBase):
    """FM first order + the pairwise second order (0.5[(sum v)^2 -
    sum v^2]) + a deep MLP over the same embeddings."""

    def __init__(self, field_dims: Sequence[int], dense_dim: int = 13,
                 embedding_dim: int = 16,
                 hidden_sizes: Sequence[int] = (128, 64),
                 sparse=False, sparse_lr: float = 0.05,
                 heter_capacity: int = 0,
                 heter_optimizer: str = "adagrad"):
        super().__init__(field_dims, dense_dim, embedding_dim, sparse,
                         sparse_lr, heter_capacity, heter_optimizer)
        self.dense_first = nn.Linear(dense_dim, 1)
        self.deep = _mlp(self.num_fields * embedding_dim + dense_dim,
                         hidden_sizes)

    def forward(self, ids, dense=None):
        if dense is None:
            ids, dense = ids
        first_f, v = self._wide_and_emb(ids)               # (B,F), (B,F,E)
        dense = torch.as_tensor(dense, device=v.device).to(v.dtype)
        first = first_f.sum(dim=1) + self.dense_first(dense)[:, 0]
        second = 0.5 * (v.sum(dim=1).square() - v.square().sum(dim=1)) \
            .sum(dim=-1)
        deep_in = torch.cat([v.reshape(v.shape[0], -1), dense], dim=-1)
        return first + second + self.deep(deep_in)[:, 0]
