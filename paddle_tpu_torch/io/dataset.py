"""Datasets (port of ``paddle_tpu/io/dataset.py``; reference
python/paddle/io/__init__.py, fluid/dataloader/dataset.py).

``TensorDataset`` holds torch tensors (a numpy array is taken over without
a copy, ``torch.as_tensor``); a sample is a tuple of their rows.
``random_split`` draws its permutation from numpy's global state, as the
reference does, so both packages split alike under one ``np.random.seed``;
given a ``torch.Generator`` it draws from that instead.
"""
from __future__ import annotations

import bisect

import numpy as np
import torch

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "ConcatDataset", "Subset", "random_split"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    """A stream of samples. Inside a ``DataLoader`` it is read in the
    loading process (as the reference reads it), where
    ``get_worker_info()`` is None: a dataset that shards itself by worker
    gives the whole stream there."""

    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset has no __getitem__")

    def __len__(self):
        raise RuntimeError("IterableDataset has no __len__")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        self.tensors = [torch.as_tensor(t) for t in tensors]
        n = self.tensors[0].shape[0]
        if any(t.shape[0] != n for t in self.tensors):
            raise ValueError("TensorDataset: tensors differ in their first "
                             "dimension")

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    """Samples of several datasets side by side, flattened into one
    tuple."""

    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        sample = []
        for d in self.datasets:
            item = d[idx]
            sample.extend(item if isinstance(item, (list, tuple)) else [item])
        return tuple(sample)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum(
            [len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx = len(self) + idx
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        off = idx - (self.cumulative_sizes[ds_idx - 1] if ds_idx > 0 else 0)
        return self.datasets[ds_idx][off]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    """Disjoint ``Subset``s of the given lengths over a random permutation
    (numpy's global state, or ``generator``'s when one is given)."""
    total = len(dataset)
    if sum(lengths) != total:
        raise ValueError("sum of lengths != dataset size")
    if generator is None:
        perm = np.random.permutation(total).tolist()
    else:
        perm = torch.randperm(total, generator=generator).tolist()
    out, off = [], 0
    for ln in lengths:
        out.append(Subset(dataset, perm[off:off + ln]))
        off += ln
    return out
