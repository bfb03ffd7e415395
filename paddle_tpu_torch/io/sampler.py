"""Samplers (port of ``paddle_tpu/io/sampler.py``; reference
fluid/dataloader/batch_sampler.py, sampler.py).

Index lists are the reference's under one ``np.random.seed``:
``RandomSampler`` and ``WeightedRandomSampler`` draw from numpy's global
state as it does (``RandomSampler`` from a ``torch.Generator`` when one is
given), ``DistributedBatchSampler`` shuffles with ``RandomState(epoch)``
and pads to an even split, rank by rank.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Sampler", "SequenceSampler", "RandomSampler",
           "WeightedRandomSampler", "BatchSampler", "DistributedBatchSampler"]


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))

    def __len__(self):
        return len(self.data_source)


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        g = self.generator
        if self.replacement:
            if g is not None:
                return iter(torch.randint(0, n, (self.num_samples,),
                                          generator=g).tolist())
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        if g is not None:
            return iter(torch.randperm(n, generator=g)[:self.num_samples]
                        .tolist())
        return iter(np.random.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


def _batches(indices, batch_size, drop_last):
    batch = []
    for idx in indices:
        batch.append(idx)
        if len(batch) == batch_size:
            yield batch
            batch = []
    if batch and not drop_last:
        yield batch


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        if sampler is None:
            sampler = (RandomSampler(dataset) if shuffle
                       else SequenceSampler(dataset))
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        yield from _batches(self.sampler, self.batch_size, self.drop_last)

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Each data-parallel rank's batches: the indices (shuffled by
    ``RandomState(epoch)``, the epoch advancing each pass) padded to a
    multiple of the ranks, this rank taking every ``nranks``-th."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        from ..distributed.env import get_rank, get_world_size
        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = (num_replicas if num_replicas is not None
                       else get_world_size())
        self.local_rank = rank if rank is not None else get_rank()
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(np.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.epoch).shuffle(indices)
            self.epoch += 1
        indices = np.concatenate([indices, indices[:self.total_size - n]])
        indices = indices[self.local_rank::self.nranks]
        yield from _batches(indices.tolist(), self.batch_size,
                            self.drop_last)

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch
